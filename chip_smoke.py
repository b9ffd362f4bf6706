#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (deeplearning4j_tpu_torch) on one card.

    python3 chip_smoke.py

1. Prints the card's name and power limit (nvidia-smi).
2. Builds every CUDA kernel of the port from csrc/ (one nvcc per source, all
   started together) and prints the build seconds and a summary of nvcc's
   -Xptxas -v report (registers, shared memory, spills), and counts the
   bf16 tensor-core instructions (HMMA.16816.F32.BF16, cuobjdump -sass) in
   the three flash libraries, each of which must hold some. The first
   designs of int4_dot, bn_act_fwd, bn_act_bwd, adc_pq, adc_ivf_pq,
   flash_attn_fwd, scatter_add, flash_attn_bwd_dkv (flash_attn_bwd_v1.cu)
   and flash_attn_bwd_dq (csrc/*_v1.cu), and of the bn kernels' split
   launches (csrc/bn_act_split_v1.cu), are built beside them and timed on
   the same operands as "previous_ms".
3. Kernel phases: holds each kernel against its plain PyTorch version on the
   card at the shapes its path gives it, and times both (CUDA events, median
   of 25 launches after warm-up, L2 flushed before each launch and a device
   sleep between the flush and the start event, so that the host's enqueue
   stays out of device times), beside the bound the card's published peaks
   allow and a library call that computes the same function (a yardstick
   the port never calls). Each kernel's wrapper is also timed on the host
   clock from an idle card until it returns ("host_ms"), so that host work
   a wrapper adds stays visible.
   - int4_dot, bitwise against its plain version and against itself, at
     VGG16's fc shapes.
   - bn_act_fwd / bn_act_bwd at ResNet50's batch-norm shapes at batch 128
     (stem, res2, res3, res4, res5) and a ragged one, in bf16 and float32. Stats
     (mean, var, inv) within rtol 1e-5 / atol 1e-6 of the plain version.
     out: at the kernel's own stats, bitwise the plain elementwise math;
     against the whole plain version, float32 within rtol 1e-5 / atol 1e-6
     and bf16 within 2 bf16 ulps of the largest addend of the
     pre-activation and within the bound derived from a one-step change of
     each channel's bf16 scale and shift and one ulp a rounding
     (_derived_out_bound). The library yardsticks: F.batch_norm + act and
     its autograd backward, and SyncBatchNorm's primitives. Backward, from
     the same saved stats: dpre bitwise; dgamma/dbeta within rtol 1e-4 of
     the plain float32 sums (1.6 M rows summed in another order); dz
     within rtol 1e-4 (float32) or 2 bf16 ulps, plus 1e-5 of its largest
     magnitude (it inherits the sums' rounding). Two runs of each kernel agree bitwise. Each kernel's first
     design is timed beside it.
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
     against themselves, at b = 1, 8, 32, 64, 256 on the built indexes (the IVF
     kernel on the index's real probe slots, p = 8) and at ragged shapes
     (the p = 32 one takes the global-LUT path); timed beside the bound,
     the plain version and F.embedding_bag(mode="sum"), whose max |diff|
     is printed (its sum order may differ); each kernel's first design
     too, adc_ivf_pq's held bitwise against the redesign.
     int4_dot at (b, 1M, 64) for the same b, bitwise against its plain
     version and itself.
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
     hot row; the kernel alone, its first design (previous_ms), the sort
     alone, the sort + kernel wrapper, the plain version and
     Tensor.index_add_ (atomics; its max |diff| printed) timed beside the
     bound.
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
   bounds; each kernel's first design (previous_ms) too.
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
15. Char-RNN phase (BASELINE configs[2], bench.py bench_graveslstm at full
   width): TextGenerationLSTM (two GravesLSTM(256), a 47-way softmax,
   RmsProp 1e-2) trained through MultiLayerNetwork.fit with tBPTT 50 on
   one-hot characters and labels from numpy.random.default_rng(0), batch
   64: 3 warm-up windows, then one timed sequence of 30 windows (1,500
   characters). chars/s, median window ms, the losses (finite, the last
   below the first), no kernel of the port launched, one window profiled
   (host launch calls, idle share), and 10 rnn_time_step calls against the
   stateless forward of the same prefix within 1e-5. Then card against
   CPU: a 2-window fit in float32 on the card and on the CPU and in
   float64 on the CPU (the referee): window losses and every updated
   parameter within 4x the CPU float32 run's distance to the referee or
   1e-5 of its largest magnitude; the same fit with the peepholes zeroed,
   and with the carries dropped between the windows, must miss.
16. Graph char-RNN phase: the char-RNN of 15 built with GraphBuilder, trained
   through ComputationGraph.fit with tBPTT 50 on text of uneven length
   (features and labels masks, row lengths from numpy.random.default_rng(1)
   in 750-1500): the same window losses and every parameter bitwise equal
   to the MultiLayerNetwork of 15 on the same weights and masked data;
   chars/s over the unmasked characters, median window ms, one masked
   window profiled (idle share); 10 rnn_time_step calls on the graph
   against its stateless forward within 1e-5; then the masked 2-window
   card-against-CPU fit with the float64 referee and both controls, under
   15's limits.
17. Checkpoint phase: the training network of 5 (ResNet50 bf16, Adam 1e-3)
   on 5 distinct batches of 128 drawn on the card, 2 epochs through
   ComputationGraph.fit under cudnn.deterministic: two uninterrupted runs
   agree bitwise (the determinism control); a run with
   CheckpointManager(save_every_n_steps=3) and FaultInjector(kill_at_step=7)
   crashes, restore_latest comes back at (step 6, epoch 1, batch 1), and the
   resumed fit ends bitwise equal to the uninterrupted run (masters, BN
   running stats, Adam state, counters, dropout generator); resuming
   without the updater state, or without skipping the consumed batches,
   must not; tear_file on the newest checkpoint falls back to the one
   before it. 53 + 53 bn launches a step. Bytes a checkpoint printed.
18. Serialization phase: the resumed network written by write_model,
   restored on the CPU and on the card, bitwise; one seeded image's float32
   forward on both against a float64 referee under 6's limit.
19. Checkpoint overhead (bench.py bench_checkpoint at ResNet50 width): step
   ms with checkpointing off, async every 10 and sync every 10 steps (30
   steps each, off again at the end), overhead_async_pct, snapshot ms on
   the training thread beside a pageable .cpu() copy of the same tensors,
   commit ms on the writer, and backpressure; the JAX bench's < 10% bar
   printed, not gated.
20. bn_act shapes of slice 13, in step 3's form, limits and columns:
   TinyYOLO's seven batch-norm shapes at batch 64 (11,075,584 x 16 to
   10,816 x 1,024, bf16 leaky ReLU; the first also in float32), the fused
   separable head's 200,704 x 128 and the fused 1-D head's 65,536 x 256.
21. TinyYOLO detection training, the main path of this slice: the
   detection configuration (416 x 416 x 3, 20 classes, the five VOC anchor
   priors of tiny-yolo-voc.cfg) after conf.fused() (7 fused leaky-ReLU
   blocks), bf16 with float32 masters, its own Nesterovs(1e-3, 0.9), batch
   64 of synthetic images and boxes from numpy.random.default_rng(0),
   through MultiLayerNetwork.fit, 20 steps with DL4J TinyYOLO.java's
   RenormalizeL2PerLayer gradient normalization on every layer (without
   it a width/height logit falls below exp's float32 range within 10-16
   steps and the loss's sqrt turns the gradient NaN, in float32 as in
   bf16: tools/yolo_divergence.py): losses finite, the last below the
   first, 7 + 7 bn launches a step and no other kernel; step ms, images/s,
   one step profiled by kernel family with its idle share.
22. TinyYOLO card against CPU at 64 x 64 (a 2 x 2 grid), float32, batch 2,
   one Sgd step: loss, three gradients against a float64 referee, the
   running stats, and get_predicted_objects' boxes and classes, under the
   limits yolo_card_vs_cpu_phase states; a ReLU control must miss.
23. FaceNetNN4Small2 training with its defaults (96 x 96 x 3, CenterLoss,
   Adam 1e-3, 1,000 classes), fused (37 blocks, no BatchNormalization
   left), bf16, batch 64, 10 steps through ComputationGraph.fit: losses
   finite and falling, the centers off zero, 37 + 37 bn launches a step.
24. Zoo: AlexNet, Darknet19, GoogLeNet, InceptionResNetV1,
   FaceNetNN4Small2, SimpleCNN and TinyYOLO's backbone at their published
   input shapes: parameter count, a float32 forward at batch 2 against the
   CPU, fold_bn against the unfolded network, one bf16 fit step fused.
25. Layer families: the fused separable and 1-D chains, a VAE's
   pretrain_layer, and a CenterLossOutputLayer, an LRN and an
   Upsampling/Cropping/ZeroPadding network, one step each on the card
   against the CPU, bn launches counted where the chains fused.
26. Model server: one ModelServer on the card (port 0, loopback) serves
   zoo VGG16 at 224 x 224 x 3, calibrated on two seeded batches and
   quantized to int4 through add_model(quantize=, weight_bits=4,
   warmup_example=), beside the PQ and IVF-PQ indexes of 7 as built there
   (add_index, k_max 128). /readyz must answer 503 before warm-up and 200
   after. Four client threads each send 8 predict requests of 1-4 rows
   (binary float32 and binary int8 on the endpoint's calibrated scale,
   alternating; one JSON float list in all) and 24 :query requests (1-8
   rows, k of 1, 10 or 32, PQ and IVF-PQ alternating). Every 200 is checked:
   predict outputs against the same rows through ep.pi.output within 1e-5
   of the row's largest magnitude, top-1 equal wherever the top-2 are more
   than 1e-4 apart; query ids and distances bitwise the index's own search
   of those rows at the k its coalesced batch dispatched with. int4_dot
   launches must equal 3 x the VGG16 dispatches (warm-up included), adc_pq
   and adc_ivf_pq launches their index dispatches. Then the taxonomy on the
   card: 400 malformed, 404, 413, a burst of four 429s with Retry-After
   against queue_depth=2 behind a held dispatch, 504 on a 50 ms deadline
   behind it, 503 and /readyz 503 while draining, and /metrics carrying the
   serving_ instruments. Prints p50 / p99 ms, requests/s, batch occupancy
   and bytes a request by encoding.
27. Hot swap: VGG16 float32 committed as step 1 to a CheckpointManager in a
   temporary directory (parameters only, about 553 MB; bytes and commit
   seconds printed),
   served int4 by add_model(checkpoint_manager=) with manual polling. Four
   client threads keep sending while step 2 (every weight times 1 + 0.1
   N(0, 1), seeded) is committed and poll_checkpoint() swaps it in. No
   request may fail; every answer must be, as a whole, step 1's or step 2's
   under 26's limits (the two differ by more), every request sent after the
   swap returned step 2's; stats read 1 swap at step 2; int4_dot launches
   3 x the dispatches after the swap too; a torn step 3 (tear_file) neither
   re-swaps nor downgrades. Prints the swap's off-path restore + quantize
   seconds and the longest request across it.
28. Decode: TextGenerationLSTM at BASELINE configs[2] width (two
   GravesLSTM(256), 47 characters, random weights from its seed) behind
   add_generator with bench.py bench_decode's non-QUICK load: 32 sessions x
   128 greedy tokens, prompts of 12 from numpy.random.default_rng(0),
   prefill buckets (16, 64), 32 slots. Each session's tokens must equal
   sequential greedy rnn_time_step on the card up to the first position
   where the sequential step's top-2 log-probabilities are within 1e-4
   (sessions without one must match whole; the count with one is printed).
   Zero new dispatch shapes after warmup(), one host read per dispatch.
   Engine and sequential tokens/s, TTFT and ITL p50 / p99. One :generate
   over SSE and one as JSON must equal an engine session of the same
   prompt. One "carry" hot swap while 8 sessions of 1024 tokens generate
   loses none. No
   kernel of the port launches in this phase.
29. IVF: IVFIndex(V) and IVFIndex(V, int8=True) on 7's 1,000,000 x 64
   corpus (1000 cells, nprobe 8), each dense and CSR, built on the card and
   served over HTTP behind add_index with 26's query load (answers against
   the index's own search of their rows under 7's near-tie rule: the
   batched products round with the batch's shape). Build seconds, resident bytes, p50 / p99,
   queries/s; recall@10 on the 1024 queries against 7's exact ids, gated
   0.01 under the JAX package's own IVFIndex at this configuration (JAX_IVF_RECALL,
   measured on the card host's CPU by tests/test_torch_ivf.py's __main__);
   dense and CSR must answer identically; each index saved, loaded with
   device="cpu" and asked 16 queries under 7's near-tie rule. No kernel
   launches (the IVF scorers are plain torch).
30. Data tier: ResNet50 of 5 fed from disk. 1,024 training and 256
   validation images from synthetic_images (224 x 224 x 3, 10 classes, the
   labels padded with zero columns to the 1,000-way head) are written as
   uint8 shards of 128 (write_shards into a LocalFSBackend, 198 MB) and
   read back by ShardedDataset(source=ShardFileSource) -> ShardedReader ->
   ImagePreProcessingScaler -> AsyncDataSetIterator. Printed: the host to
   card copy of one 77 MB batch from pinned and from pageable memory, and
   images/s and the train.data_wait share of one epoch through fit without
   and with prefetch. Then, under cudnn.deterministic, EarlyStoppingTrainer
   (MaxEpochs 4, ScoreImprovement 2, the validation loss, LocalFileModelSaver)
   trains it with set_augmentation(crop 16, flip 0.5, ImageNet mean / std)
   and the batches staged by DevicePrefetchIterator: every loss finite, the
   last epoch's mean below the first's, 53 + 53 bn launches a step (and 53
   forward a validation batch), the result consistent with its
   score_vs_epoch, the saved best model reloaded scoring the best score
   bitwise, evaluate's confusion matrix (counted on the card) equal to the
   host's count over output(), no batch passed through on the host. Three
   steps with and without prefetch bitwise equal; crash-exact resume
   through the reader (augmentation and prefetch on, a checkpoint every
   step, killed at step 6 of 8, restored at step 5) bitwise the
   uninterrupted run, reading only the 3 remaining batches' shards.
31. LeNet gates: mnist_data's seeded sets written as idx files (60,000 +
   10,000) under a temporary DL4J_TPU_DATA_DIR and the test set as a CSV;
   LeNet trained from MnistDataSetIterator by EarlyStoppingTrainer (at
   most 2 epochs, batch 64, prefetch), validated through
   RecordReaderDataSetIterator(CSVRecordReader) on the native parser only:
   accuracy >= 0.95; calibrate on 4 training batches,
   quantize(weight_bits=4), accuracy_delta against the fp32 net on the CSV
   with its counts recomputed on the host, the gate at the default top-1
   budget and agreement floor 0.95 and the mean NLL within 1e-3 of the
   fp32 net's (GATE_LOSS_ABS says why not the relative budget; its verdict
   is printed); int4_dot launched 2 x the 100 validation dispatches, no
   kernel in training.
32. Fused update (the bucketed updater every fit runs,
   optimize/fused_update.py): ResNet50 of 5 (224 x 224 x 3, batch 128, bf16
   on float32 masters, fused) in two copies from one init, 3 steps each on
   batches drawn on the card, Adam 1e-3 and then Nesterovs(1e-2, 0.9): one
   copy through TrainStep._apply_updates, the other through
   bucketed_apply(threshold=0) (the per-tensor path) with the same
   gradients; every parameter, updater slot and count bitwise equal after
   every step. Prints the buckets and their members, the updater's device
   launches and device ms a step for both paths (a torch.profiler window
   around the update), and for Adam the step ms median of each path through
   fit and the bucketed step's idle share.
33. Transfer learning: that Adam network through
   TransferLearning.GraphBuilder, frozen up to res4f_out (43 fused blocks
   on NoOp), res5 and a new 10-way head fine-tuned with Nesterovs(1e-4,
   0.9), 10 steps at batch 128 bf16 on data_tier's 10-class
   synthetic_images: the loss falls, every frozen vertex's parameters stay
   bitwise, every frozen block's running statistics move (train-mode BN, as
   in the JAX package), bn_act_fwd 53 and bn_act_bwd 10 launches every
   step. A CheckpointListener zip (every 5 iterations) read back by restore
   equals the network of its step bitwise; PerformanceListener samples/s
   and CollectScoresIterationListener scores printed. Step ms and idle share
   beside the full network's of 32. TransferLearningHelper(graph,
   "res4f_out"): 4 batches featurized in eval mode (no bn launch), then
   fit_featurized on each (10 + 10 bn launches a step), its parameters
   folded back bitwise. get_memory_report(minibatch=128) on the card: rows
   equal to a CPU copy's report, the measured step's peak printed. Then a
   narrow graph of three fused blocks (two frozen) fine-tuned 3 steps on the
   card (3 + 1 bn launches a step) and on the CPU in float32: loss within
   rtol 1e-4, every parameter and running statistic within 1e-4 of its
   tensor's largest magnitude, frozen parameters bitwise on both.
34. Solvers: LeNet (configs[0]) on 2,048 synthetic MNIST images as one
   batch, for lbfgs, conjugate_gradient and line_gradient_descent: fit with
   the default Solver of each (no kernel of the port launched, lbfgs's
   score lower after); Solver(algo) called directly for 20 iterations (the
   backtracking search up to 20 trials): scores finite and falling, ms an
   iteration printed; card against CPU on seeds 0-2, the first 5 scores
   each within its own limit of the CPU's, relative to the CPU score
   (SOLVER_RTOL, set from readings), and a control with every gradient
   perturbed by 10% of its norm that the limits must catch (a 1% probe is
   printed).
35. Streaming: a StreamingHttpReceiver on a free loopback port takes 8
   .npz batches of 64 from a client thread while LeNet's fit(prefetch=True)
   consumes the StreamingDataSetIterator on the card: every POST 200, every
   batch consumed once, one step a batch; batches and wall time printed.
36. Cloud checkpoint: 17's crash -> restore -> resume with every checkpoint
   through backend_from_url(<ObjectStoreEmulator>/ckpt, cache_dir=,
   cache_bytes=2 GiB), a CachedBackend over RetryingBackend over
   CloudObjectBackend on loopback HTTP. Scripted: three 503s with
   Retry-After on the first multipart part and a 500 on the first
   complete (4 torn uploads aborted, none in flight, the bucket lists only
   the journal's objects), a mid-transfer disconnect on the restore's get
   (retried), rot in transit on the newest checkpoint (a cold reader's
   restore_latest falls back from step 9 to 6). The resumed run bitwise
   17's uninterrupted one; a second restore through the same cache hits
   it; CheckpointManager(sharded=True) over the same stack saves and
   restores the resumed network bitwise, and a simulated 4-shard set of it
   restores into one network bitwise (N -> M), state_sha equal. Prints
   bytes a checkpoint, put and get MB/s of its bytes over loopback, and
   the emulator's, client's, retry layer's and cache's counters.
37. Supervised: train_until_process runs 17's schedule in a python3 -c
   worker on the card (local checkpoints every 3 steps); the worker is
   killed by a real SIGKILL at step 7 (FaultInjector kill_mode="process"),
   respawned, restores step 6 and finishes: one restart, the crash a
   Preempted SIGKILL at store step 6, the final state_sha equal to 17's
   uninterrupted run's. Prints each attempt's seconds from spawn to its
   first step and the crash record.
38. Graph embeddings: a seeded planted-partition graph of BlogCatalog's
   size (10,312 vertices, 333,983 edges, 39 blocks, 80% of edges inside a
   block). DeepWalk (d 128, walk length 40, window 10, 5 negatives, 3
   walks a vertex, cut from the paper's 80) and Node2Vec (p 1, q 0.5, walk
   length 80, window 10, one walk a vertex, rate 0.1), both at batch 8192,
   through
   fit on the card: 3 scatter_add launches a corpus batch and no other
   kernel, the first launch of each fit bitwise against the plain
   version; the same-block share of verts_nearest(v, 10) over 1,000
   sampled vertices at least 0.25 (10x chance), which a control trained on
   the same walks with the vertex ids shuffled must miss. VPTree, KDTree
   and NearestNeighborsServer /knn over the DeepWalk vectors: the ids of
   a float64 torch.cdist brute force on the card, ordered by (distance,
   index), for 10 queries. BarnesHutTsne at the JAX defaults (perplexity
   30, exaggeration 12) but 500 iterations, approximate on all 10,312
   vectors and exact on 2,000: the 2-D block share against the control's
   embedding under the same gate; one step of each regime on the card
   within 1e-5 of the CPU's (of the embedding's largest magnitude; KL
   relative). Prints walk and fit seconds, words/s, launches,
   iterations/s and the KL histories.
39. CNN sentence: the sentence CNN of Kim 2014 at its widths (300-d
   vectors from the port's Word2Vec on the card, at most 56 words, filters
   3/4/5 x 100, max over time, MergeVertex, dropout 0.5, softmax, batch
   50) on a seeded two-class synthetic corpus of 10,662 sentences laid
   out by CnnSentenceDataSetIterator, ComputationGraph.fit with Adam 1e-3
   for 2 epochs over 9,000: losses finite and falling, the held-out
   accuracy 0.2 above a control trained on shuffled labels, no kernel of
   the port launched.
40. Parallel training: ResNet50 of 17 through ClusterTrainer, bitwise
   ComputationGraph.fit with no process group and in an NCCL group of one
   (one all-reduce a step), then 20 steps with ThresholdCompression (loss
   falling; ratio, tau, residual norm, the apply's device ms; no host sync
   added to the step under set_sync_debug_mode) and one apply held
   against the CPU's (see parallel_training_phase).
41. Elastic: the same network through an ElasticWorker at world 1 across
   three generations (a requested bump after epoch 1, then a hung guarded
   call escalating to a bump), its final state_sha equal to an
   uninterrupted ClusterTrainer run's (see elastic_phase).
42. Fleet (after hot_swap, budget 40 s): two restore_and_serve replicas,
   each a subprocess on the card, serve the model_server phase's VGG16
   with 4-bit weights from one checkpoint behind a FleetRouter; a burst of
   predicts through the router with one replica SIGKILLed mid-burst:
   every answer byte for byte the surviving replica's direct answer, only
   200s once the killed lease lapsed; the router hop's p50 overhead; each
   replica's int4_dot launches (see fleet_phase).
43. Data-parallel world 2 (after elastic, budget 60 s): ResNet50 through
   ClusterTrainer in two processes on the one card over gloo, 64 rows a
   rank: the bn wrappers take the split launches; each rank's split bn
   outputs against the plain versions on the whole batch; 3 float32 steps
   held, with fit on the global batch, to a float64 referee (the whole
   update and its worst leaf within 3x fit's own distances from it, losses
   within 1e-3, the first within 1e-5), and the same steps with per-rank
   statistics rejected by those limits; 2 x 53 + 1 all-reduces a float32
   step; bf16 step ms against fit's, gloo's share of the step (see
   data_parallel_world2_phase).
44. Model parallel (budget 50 s): in an NCCL group of one,
   ParallelWrapper(tensor_parallel=True) trains ResNet50 bitwise fit;
   ring_self_attention and ulysses_self_attention at (8, 12, 1024, 64)
   causal float32 against reference_attention and the flash kernel, with
   gradients; GPipeTrainer at one stage on 12 residual MLP blocks of
   GPT-2 small's widths against the sequential stack; then the split bn
   launches at world 1 bitwise the one launch in both directions at res2,
   res4 and the ragged 1,001 x 130 in both dtypes, float32's statistics
   launch held to bn_fwd_partials_plain and its combination to
   combine_rank_partials, timed beside their first design, the one launch,
   F.batch_norm and SyncBatchNorm's primitives (see model_parallel_phase,
   _split_times).
45. Keras ResNet50 (after perf_tier): Keras's own ResNet50 config
   (tests/data/keras/resnet50_config.json, the JSON Keras 3.13.1 writes for
   keras.applications.ResNet50(weights=None)), weights drawn from numpy on
   a seed in Keras's order and shapes, imported through
   import_keras_model_and_weights (an in-memory archive with Hdf5Archive's
   read surface where h5py is missing, printed as "keras_archive:"; a
   legacy .h5 and load_model_guess where it imports) on the card and the
   CPU, fused to 53 blocks and fine-tuned (Adam 1e-4, b = 32 float32):
   eval output at b = 4 and the first loss against the CPU's; 3 steps of 53
   + 53 bn launches under a StatsListener at frequency 1 writing to a
   FileStatsStorage and over a RemoteUIStatsStorageRouter to a UIServer on
   127.0.0.1; every report's statistics against numpy on host copies
   (counts, min, max exact; moments within 1e-12 of the leaf's largest
   magnitude); the UI routes; step ms with and without the listener (see
   keras_resnet50_phase). The bn kernels are held at this path's shapes
   (KERAS_BN_CASES) in step 3's form.
46. Keras CNN: a Sequential CNN with batch norm imported as a
   MultiLayerNetwork, fused, 3 steps under the listener: every record
   carries activations (see keras_cnn_phase).
47. Estimator: DL4JClassifier on a seeded 4-class set on the card, bitwise
   a MultiLayerNetwork fit on the same seed and batches (see
   mlpipeline_phase).
48. Prints the kernels JSON line (nine kernels; the bn rows' launches by
   path, data_tier, fused_update, transfer_learning, fit_featurized,
   cloud_checkpoint, supervised, parallel, parallel_compressed, elastic,
   data_parallel_world2, model_parallel, perf_tier, keras_resnet50 and
   keras_cnn included, and a "split" entry
   with the split launches' times; scatter_add's by path
   (word2vec, deepwalk, node2vec), and int4_dot's, adc_pq's and adc_ivf_pq's with the
   model_server, hot_swap, ivf, lenet_gates and fleet paths; int4_dot's library
   yardstick, torch._int_mm, on operands zero-padded to its multiples of 8,
   the weights column-major, and held equal to the kernel's result), the
   card line, and last
   {"ok": true, "device": {...}}.

Any failure raises and exits non-zero before the last line. Without a CUDA
device the script exits 2 and prints no result.
"""

from __future__ import annotations

import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np

PEAK_BYTES_PER_S = 3.35e12     # H100 SXM HBM3, NVIDIA data sheet
PEAK_INT8_OPS_PER_S = 1.979e15  # H100 SXM dense int8 tensor-core rate
PEAK_F32_OPS_PER_S = 67e12     # H100 SXM float32 outside the tensor cores
SLEEP_CYCLES = 500_000         # about 0.25 ms of the card's clock: time_ms's head start
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
    ("res3", 100352, 128, "bfloat16", "relu", False),
    ("res3", 100352, 512, "bfloat16", "relu", True),
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
# the served pow2 buckets: 1-8 rows (one request), 32 (1-4 coalesced ones),
# 64, and 256 (the warm-up's largest)
ADC_BATCHES = [1, 8, 32, 64, 256]
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
# the char-RNN (BASELINE configs[2], bench.py bench_graveslstm): vocabulary,
# batch, tBPTT window, windows in the timed sequence, warm-up windows; 10
# single rnn_time_step calls against the stateless forward of that prefix
# (float32; the stateless forward projects the 10 steps' inputs in one
# product, the steps one row block each, which cuBLAS may sum otherwise)
CHAR_VOCAB, CHAR_BATCH, CHAR_T, CHAR_WINDOWS, CHAR_WARM = 47, 64, 50, 30, 3
CHAR_STEPS, CHAR_STEP_ATOL = 10, 1e-5
# card against CPU: a 2-window fit; the card's distance to the float64
# referee within CHAR_CHECK_MULT times the CPU float32 run's, or
# CHAR_CHECK_FRAC of the referee's largest magnitude
CHAR_CHECK_WINDOWS, CHAR_CHECK_MULT, CHAR_CHECK_FRAC = 2, 4.0, 1e-5
# the checkpoint phase (tests/test_checkpoint.py:80-111's schedule at ResNet50
# width): batches an epoch, epochs, the step trigger, the injected crash, and
# where restore_latest must come back, (step, epoch, batch_in_epoch)
CKPT_BATCHES, CKPT_EPOCHS, CKPT_EVERY, CKPT_KILL = 5, 2, 3, 7
CKPT_RESTORED = (6, 1, 1)
# checkpoint_overhead (bench.py bench_checkpoint at ResNet50 width): warm-up
# steps, timed steps a mode, the save interval; the JAX bench's bar, printed
OVERHEAD_WARM, OVERHEAD_STEPS, OVERHEAD_EVERY, OVERHEAD_BAR_PCT = 3, 30, 10, 10.0
# graph_char_rnn: each row's length in characters, numpy.random.default_rng(1)
# in [GRAPH_CHAR_MIN, CHAR_T * CHAR_WINDOWS]
GRAPH_CHAR_MIN = 750


def card_line() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True, text=True,
                       check=True, timeout=60)
    return r.stdout.strip().splitlines()[0]


def time_ms(torch, fn, flush, reps: int = 25, warm: int = 3) -> float:
    """Median device time of one ``fn()`` call, L2 flushed before each. A
    device-side sleep between the flush and the start event lets the host
    enqueue the call before the card reaches it, so that a small kernel's
    time holds no host time."""
    for _ in range(warm):
        fn()
    pairs = []
    for _ in range(reps):
        flush.zero_()
        torch.cuda._sleep(SLEEP_CYCLES)
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        pairs.append((s, e))
    torch.cuda.synchronize()
    return float(np.median([s.elapsed_time(e) for s, e in pairs]))


def host_ms(torch, fn, reps: int = 25, warm: int = 3) -> float:
    """Median host time of one ``fn()`` call, from the idle card until the
    call returns: a wrapper's own checks, allocations and launch enqueues
    (and device time only where the wrapper waits for the card). time_ms's
    sleep hides this from the device times."""
    for _ in range(warm):
        fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    torch.cuda.synchronize()
    return 1e3 * float(np.median(times))


def int4_dot_bound(b: int, n: int, d: int):
    """(ms, "bytes"|"operations"): each input read once, the output written
    once, 2*b*n*d int8 operations, at the card's published peaks."""
    t_bytes = (b * d + n * ((d + 1) // 2) + 4 * b * n) / PEAK_BYTES_PER_S
    t_ops = 2.0 * b * n * d / PEAK_INT8_OPS_PER_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def _first_design(name: str, argtypes, source: str = ""):
    """The C entry <name>_v1_launch of a kernel's first design
    (csrc/<source>.cu, by default <name>_v1), the yardstick its redesign is
    timed against: previous_ms. ``argtypes`` leaves out the trailing
    stream."""
    import ctypes

    from deeplearning4j_tpu_torch.perf.kernels import _build
    fn = getattr(_build.load(source or f"{name}_v1"), f"{name}_v1_launch")
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
    wrapper_host_ms = host_ms(torch, lambda: int4_dot.int4_matmul(qq, packed, d))
    previous_ms = time_ms(torch, lambda: first_design_int4(torch, qq, packed, d), flush)
    plain_ms = time_ms(torch, lambda: int4_dot.int4_matmul_plain(qq, packed, d),
                       flush)
    # torch._int_mm needs more than 16 rows and k and n multiples of 8: the
    # yardstick runs the same operands zero-padded, queries to a multiple of
    # 32 rows, k and n to multiples of 8 (outside the timed call), the
    # weights as the table's rows unpacked, so B = wpad.t() is column-major;
    # its int32 result must equal the kernel's on the unpadded rows and columns
    library_ms, library_note = None, None
    kpad, npad = -(-d // 8) * 8, -(-n // 8) * 8
    wpad = torch.zeros((npad, kpad), dtype=torch.int8, device=dev)
    wpad[:n, :d] = unpack_nibbles(packed, d)
    w8t = wpad.t()
    qpad = torch.zeros((max(32, -(-b // 32) * 32), kpad), dtype=torch.int8,
                       device=dev)
    qpad[:b, :d] = qq
    try:
        lib = torch._int_mm(qpad, w8t)[:b, :n]
        if not torch.equal(lib, got.to(lib.dtype)):
            raise AssertionError(f"torch._int_mm differs from int4_dot at b={b} n={n} d={d}")
        library_ms = time_ms(torch, lambda: torch._int_mm(qpad, w8t), flush)
        library_note = (f"torch._int_mm on unpacked int8 weights, operands zero-padded "
                        f"to ({qpad.shape[0]}, {kpad}) x ({kpad}, {npad}), B column-major")
    except RuntimeError as e:
        library_note = f"torch._int_mm refused: {str(e).splitlines()[0]}"
    bound_ms, bound_by = int4_dot_bound(b, n, d)
    row = {"b": b, "n": n, "d": d, "max_abs_err": err, "ms": ms, "host_ms": wrapper_host_ms,
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
                x, _ = net._pre[i].apply(x, None)
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


def first_design_rows(n: int, c: int):
    """(row blocks, rows per block) of the bn kernels' first designs: blocks
    of 32 channels by 8 row lanes, about 8 blocks an SM of an H100 (132
    SMs), each with at least 8 rows."""
    tiles = -(-c // 32)
    nrb = max(1, min(-(-(132 * 8) // tiles), -(-n // 8)))
    rpb = -(-n // nrb)
    return -(-n // rpb), rpb


def first_design_bn_fwd(torch, act, z, gamma, beta, res):
    """bn_act_fwd's first design (scalar loads, threads along C, three
    launches; five in float32) on the same operands."""
    import ctypes

    from deeplearning4j_tpu_torch.perf.kernels import bn_act
    P, I, L, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
    fn = _first_design("bn_act_fwd", [I, I, P, P, P, P, L, I, F, P, P, P, P, P, I, L])
    c = z.shape[-1]
    n = z.numel() // c
    nrb, rpb = first_design_rows(n, c)
    out = torch.empty_like(z)
    mean, var, inv = (torch.empty(c, dtype=torch.float32, device=z.device) for _ in range(3))
    scratch = torch.empty(2 * nrb * c + 2 * c, dtype=torch.float32, device=z.device)
    err = fn(bn_act._DTYPES[z.dtype], bn_act.KERNEL_ACTS[act], z.data_ptr(), gamma.data_ptr(),
             beta.data_ptr(), None if res is None else res.data_ptr(), n, c, BN_EPS,
             out.data_ptr(), mean.data_ptr(), var.data_ptr(), inv.data_ptr(),
             scratch.data_ptr(), nrb, rpb, torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"bn_act_fwd_v1 launch failed with CUDA error {err}")
    return out, mean, var, inv


def first_design_bn_bwd(torch, act, z, gamma, beta, res, mean, inv, dout):
    """bn_act_bwd's first design (scalar loads, threads along C) on the same
    operands."""
    import ctypes

    from deeplearning4j_tpu_torch.perf.kernels import bn_act
    P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    fn = _first_design("bn_act_bwd", [I, I, P, P, P, P, P, P, P, L, I, P, P, P, P, P, I, L])
    c = z.shape[-1]
    n = z.numel() // c
    nrb, rpb = first_design_rows(n, c)
    dz = torch.empty_like(z)
    dpre = None if res is None else torch.empty_like(z)
    dg, db = (torch.empty(c, dtype=torch.float32, device=z.device) for _ in range(2))
    scratch = torch.empty(2 * nrb * c + 4 * c, dtype=torch.float32, device=z.device)
    ptr = (lambda a: None if a is None else a.data_ptr())
    err = fn(bn_act._DTYPES[z.dtype], bn_act.KERNEL_ACTS[act], z.data_ptr(), gamma.data_ptr(),
             beta.data_ptr(), ptr(res), mean.data_ptr(), inv.data_ptr(), dout.data_ptr(), n, c,
             dz.data_ptr(), dg.data_ptr(), db.data_ptr(), ptr(dpre), scratch.data_ptr(), nrb,
             rpb, torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"bn_act_bwd_v1 launch failed with CUDA error {err}")
    return dz, dg, db, dpre


def bn_operands(torch, dev, n, c, dtype_name, act, residual):
    """Seeded (z, gamma, beta, res) of one batch-norm shape, the forward's
    (out, mean, var, inv) through the kernel, and a dout from them."""
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
    fwd = bn_act.bn_act_fwd(act, BN_EPS, z, gamma, beta, res)
    dout = (fwd[0].float() + 0.5 + 0.1 * torch.randn((n, c), generator=gen, device=dev)).to(dt)
    return (z, gamma, beta, res), fwd, dout


def hold_bn_bwd(torch, label, got, want) -> float:
    """Hold bn_act_bwd's (dz, dgamma, dbeta, dpre) against the plain
    version's from the same saved stats: dpre bitwise, dgamma/dbeta within
    rtol 1e-4, dz within rtol 1e-4 (float32) or 2 bf16 ulps, plus 1e-5 of
    its largest magnitude. Returns max |dz - plain|."""
    (dz, dg, db, dpre), (p_dz, p_dg, p_db, p_dpre) = got, want
    if dpre is not None and not torch.equal(dpre, p_dpre):
        raise AssertionError(f"bn_act_bwd {label}: dpre differs from the plain version")
    _close(f"bn_act_bwd dgamma {label}", dg, p_dg, 1e-4, 1e-6 * float(p_dg.abs().max()))
    _close(f"bn_act_bwd dbeta {label}", db, p_db, 1e-4, 1e-6 * float(p_db.abs().max()))
    err = _max_err(dz, p_dz)
    dz_floor = 1e-5 * float(p_dz.float().abs().max())
    if dz.dtype == torch.float32:
        _close(f"bn_act_bwd dz {label}", dz, p_dz, 1e-4, dz_floor)
    else:
        mag = torch.maximum(dz.float().abs(), p_dz.float().abs())
        _hold(f"bn_act_bwd dz {label} (2 bf16 ulps)",
              (dz.float() - p_dz.float()).abs() <= 2 * _bf16_ulp(torch, mag) + dz_floor, err)
    return err


def _derived_out_bound(torch, act, z, res, scale, shift, p_scale, p_shift):
    """Elementwise bound on |out - plain out| below float32 when the two
    differ only in their statistics: the triangle inequality through each
    rounding of out = act(T(T(T(z*T(scale)) + T(shift)) + res)). With s, h
    the scale and shift cast to z's type T (kernel k, plain p): |z| |s_k -
    s_p| + |h_k - h_p| (a channel's one-step change of each) + one ulp of T
    at the larger of the two magnitudes for each rounding (the product, the
    shift's add, the residual's add; leaky-ReLU's product), each version
    rounding within half an ulp."""
    dt = z.dtype
    zf = z.float()
    s_k, s_p = scale.to(dt).float(), p_scale.to(dt).float()
    h_k, h_p = shift.to(dt).float(), p_shift.to(dt).float()
    tiny, eps = torch.finfo(dt).tiny, torch.finfo(dt).eps

    def ulp(a, b):
        mag = torch.maximum(a.abs(), b.abs()).clamp_min(tiny)
        return torch.exp2(torch.floor(torch.log2(mag))) * eps

    x_k, x_p = (zf * s_k).to(dt).float(), (zf * s_p).to(dt).float()
    bound = zf.abs() * (s_k - s_p).abs() + (h_k - h_p).abs() + ulp(x_k, x_p)
    y_k, y_p = (x_k + h_k).to(dt).float(), (x_p + h_p).to(dt).float()
    bound += ulp(y_k, y_p)
    if res is not None:
        bound += ulp((y_k + res.float()).to(dt).float(), (y_p + res.float()).to(dt).float())
        y_k = (y_k + res.float()).to(dt).float()
    if act == "leakyrelu":
        bound += ulp(y_k, y_k * 0.01)
    return bound


def hold_bn_fwd(torch, label, operands, act, got, want) -> dict:
    """Hold bn_act_fwd's (out, mean, var, inv) against the plain version's:
    stats within rtol 1e-5 / atol 1e-6; out bitwise the plain elementwise
    math at the kernel's own stats, and against the whole plain version
    within rtol 1e-5 / atol 1e-6 (float32) or, below float32, both 2 ulps of
    z's type of the largest addend of the pre-activation and the bound
    derived from the statistics alone (_derived_out_bound). Returns max
    |out - plain| ("max_abs_err") and, below float32, the channels whose
    scale or shift in z's type differ from the plain version's
    ("flipped_channels"), the largest |out - plain| in those ulps
    ("max_err_addend_ulps") and over the derived bound
    ("max_err_of_derived_bound")."""
    from deeplearning4j_tpu_torch.perf.kernels import bn_act

    (z, gamma, beta, res), (out, mean, var, inv), (p_out, p_mean, p_var, p_inv) = \
        operands, got, want
    for what, g, w in (("mean", mean, p_mean), ("var", var, p_var), ("inv", inv, p_inv)):
        _close(f"bn_act_fwd {what} {label}", g, w, 1e-5, 1e-6)
    scale = gamma.float() * inv
    shift = beta.float() - mean * scale
    if not torch.equal(out, bn_act.bn_act_apply_plain(act, z, scale, shift, res)):
        raise AssertionError(f"bn_act_fwd {label}: out differs from the plain "
                             "elementwise math at the kernel's own stats")
    err = _max_err(out, p_out)
    if z.dtype == torch.float32:
        _close(f"bn_act_fwd out {label}", out, p_out, 1e-5, 1e-6)
        return {"max_abs_err": err}
    dt = z.dtype
    p_scale = gamma.float() * p_inv
    p_shift = beta.float() - p_mean * p_scale
    mag = torch.maximum((z.float() * p_scale.to(dt).float()).abs(), p_shift.to(dt).float().abs())
    if res is not None:
        mag = torch.maximum(mag, res.float().abs())
    mag = torch.maximum(mag, p_out.float().abs())
    ulps = (out.float() - p_out.float()).abs() / (
        torch.exp2(torch.floor(torch.log2(mag.clamp_min(torch.finfo(dt).tiny))))
        * torch.finfo(dt).eps)
    _hold(f"bn_act_fwd out {label} (2 ulps)", ulps <= 2, err)
    diff = (out.float() - p_out.float()).abs()
    bound = _derived_out_bound(torch, act, z, res, scale, shift, p_scale, p_shift)
    _hold(f"bn_act_fwd out {label} (derived bound)", diff <= bound, err)
    flipped = (scale.to(dt) != p_scale.to(dt)) | (shift.to(dt) != p_shift.to(dt))
    return {"max_abs_err": err, "flipped_channels": int(flipped.sum()),
            "max_err_addend_ulps": float(ulps.max()),
            "max_err_of_derived_bound": float((diff / bound.clamp_min(1e-30)).max())}


def _sync_bn_ms(torch, flush, z, gamma, beta, res, act, dout) -> dict:
    """SyncBatchNorm's primitives, the library's split form, at world 1:
    torch.batch_norm_stats -> batch_norm_gather_stats_with_counts ->
    batch_norm_elemt + add + activation ("sync_fwd"); the activation's
    backward, batch_norm_backward_reduce -> batch_norm_backward_elemt
    ("sync_bwd"). Timed, never called by the port."""
    from deeplearning4j_tpu_torch.nn.activations import get_activation

    c = z.shape[-1]
    n = z.numel() // c
    # a SyncBatchNorm module of z's type: weights and running statistics in
    # it, the row count in the running statistics' type
    gw, gb = gamma.to(z.dtype), beta.to(z.dtype)
    running = torch.zeros(c, dtype=z.dtype, device=z.device)
    running_var = torch.ones(c, dtype=z.dtype, device=z.device)
    counts = torch.full((1,), float(n), dtype=z.dtype, device=z.device)
    counts32 = torch.full((1,), n, dtype=torch.int32, device=z.device)
    fn = get_activation(act)

    def fwd():
        mean, invstd = torch.batch_norm_stats(z, BN_EPS)
        mean, invstd = torch.batch_norm_gather_stats_with_counts(
            z, mean[None], invstd[None], running, running_var, 0.1, BN_EPS, counts)
        y = torch.batch_norm_elemt(z, gw, gb, mean, invstd, BN_EPS)
        return fn(y if res is None else y + res), mean, invstd

    _, mean, invstd = fwd()
    pre = torch.batch_norm_elemt(z, gw, gb, mean, invstd, BN_EPS)
    if res is not None:
        pre = pre + res
    pre = pre.detach().requires_grad_(True)
    post = fn(pre)

    def bwd():
        (dy,) = torch.autograd.grad(post, pre, dout, retain_graph=True)
        sdy, sdyx, dgw, dgb = torch.batch_norm_backward_reduce(dy, z, mean, invstd, gw, True,
                                                               True, True)
        return torch.batch_norm_backward_elemt(dy, z, mean, invstd, gw.to(mean.dtype), sdy,
                                               sdyx, counts32), dgw, dgb

    return {"sync_fwd": time_ms(torch, fwd, flush), "sync_bwd": time_ms(torch, bwd, flush)}


def _bn_library_ms(torch, flush, z, gamma, beta, res, act, dout) -> dict:
    """The library yardsticks of the bn kernels (timed, never called by the
    port): F.batch_norm(training=True) + add + activation ("fwd") and its
    autograd backward ("bwd"), SyncBatchNorm's primitives ("sync_fwd",
    "sync_bwd": _sync_bn_ms), and what was timed ("note")."""
    import torch.nn.functional as F

    from deeplearning4j_tpu_torch.nn.activations import get_activation

    note = ("F.batch_norm(training=True) + add + activation; autograd backward; "
            "SyncBatchNorm's primitives (sync_*)")
    gw, gb = gamma.float(), beta.float()  # batch-norm weights in float32

    def lib_fwd(zz=z, ww=gw, bb=gb, rr=res):
        y = F.batch_norm(zz, None, None, ww, bb, training=True, eps=BN_EPS)
        return get_activation(act)(y if rr is None else y + rr)

    out = {"fwd": None, "bwd": None, "sync_fwd": None, "sync_bwd": None}
    try:
        leaves = [z.detach().requires_grad_(True), gw.detach().requires_grad_(True),
                  gb.detach().requires_grad_(True)]
        if res is not None:
            leaves.append(res.detach().requires_grad_(True))
        y = lib_fwd(*leaves)
        out["fwd"] = time_ms(torch, lib_fwd, flush)
        out["bwd"] = time_ms(torch, lambda: torch.autograd.grad(
            y, leaves, dout, retain_graph=True), flush)
        del y, leaves
    except RuntimeError as e:
        note = f"F.batch_norm refused: {str(e).splitlines()[0]}"
    try:
        out.update(_sync_bn_ms(torch, flush, z, gamma, beta, res, act, dout))
    except RuntimeError as e:
        note += f"; SyncBatchNorm's primitives refused: {str(e).splitlines()[0]}"
    return dict(out, note=note)


def bn_case(torch, dev, flush, case, n, c, dtype_name, act, residual) -> dict:
    """Hold bn_act_fwd and bn_act_bwd against their plain versions at one
    shape and time the kernels, the plain versions and the library
    yardsticks."""
    from deeplearning4j_tpu_torch.perf.kernels import bn_act

    (z, gamma, beta, res), (out, mean, var, inv), dout = bn_operands(
        torch, dev, n, c, dtype_name, act, residual)
    args = (act, BN_EPS, z, gamma, beta, res)
    p_out, p_mean, p_var, p_inv = bn_act.bn_act_fwd_plain(*args)
    bargs = (act, BN_EPS, z, gamma, beta, res, mean, inv, dout)
    dz, dg, db, dpre = bn_act.bn_act_bwd(*bargs)
    plain_bwd = bn_act.bn_act_bwd_plain(*bargs)
    torch.cuda.synchronize()
    label = f"{case} {n}x{c} {dtype_name} {act}{' +res' if residual else ''}"

    fwd_held = hold_bn_fwd(torch, label, (z, gamma, beta, res), act, (out, mean, var, inv),
                           (p_out, p_mean, p_var, p_inv))
    bwd_err = hold_bn_bwd(torch, label, (dz, dg, db, dpre), plain_bwd)
    for what, first, again in (("bn_act_fwd", (out, mean, var, inv), bn_act.bn_act_fwd(*args)),
                               ("bn_act_bwd", (dz, dg, db), bn_act.bn_act_bwd(*bargs)[:3])):
        if not all(torch.equal(a, b) for a, b in zip(first, again)):
            raise AssertionError(f"{what} {label}: two runs differ")
    del p_out, plain_bwd

    lib_ms = _bn_library_ms(torch, flush, z, gamma, beta, res, act, dout)
    lib_note = lib_ms.pop("note")

    esize = z.element_size()
    base = {"case": case, "rows": n, "channels": c, "dtype": dtype_name, "act": act,
            "residual": residual, "library": lib_note}
    row = dict(base)
    for kind, kernel, first, plain, tensors, held in (
            ("fwd", lambda: bn_act.bn_act_fwd(*args),
             lambda: first_design_bn_fwd(torch, act, z, gamma, beta, res),
             lambda: bn_act.bn_act_fwd_plain(*args), 3 if residual else 2, fwd_held),
            ("bwd", lambda: bn_act.bn_act_bwd(*bargs),
             lambda: first_design_bn_bwd(torch, act, z, gamma, beta, res, mean, inv, dout),
             lambda: bn_act.bn_act_bwd_plain(*bargs), 5 if residual else 3,
             {"max_abs_err": bwd_err})):
        bound_ms, bound_by = bn_bound(n, c, esize, tensors, BN_OPS_PER_ELT[kind])
        r = dict(base, **held, ms=time_ms(torch, kernel, flush),
                 host_ms=host_ms(torch, kernel), previous_ms=time_ms(torch, first, flush))
        r.update(plain_ms=time_ms(torch, plain, flush), bound_ms=bound_ms,
                 bound_by=bound_by, library_ms=lib_ms[kind],
                 sync_library_ms=lib_ms["sync_" + kind])
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
    """Device time of one training step of a ComputationGraph or a
    MultiLayerNetwork on ``ds`` by kernel family, from torch.profiler: the
    forward and backward in one profile (convolutions, pooling, bn_act_fwd,
    bn_act_bwd, other), the update in a second (optimizer). Runs the step
    twice and keeps the second: the first profile pays the tracer's
    start-up."""
    from torch.profiler import ProfilerActivity, profile

    from deeplearning4j_tpu_torch.datasets import MultiDataSet
    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph

    if isinstance(net, ComputationGraph):
        ds = MultiDataSet.from_dataset(ds)
    inputs, labels, fmasks, lmasks = net._batch(ds)
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    for _ in range(2):
        torch.cuda.synchronize()
        with profile(activities=acts) as fb:
            loss, grads, state = net._loss_and_grads(inputs, labels, net._gen, fmasks,
                                                     lmasks)
            torch.cuda.synchronize()
        with profile(activities=acts) as up:
            net._apply_updates(grads)
            net._commit_state(state)
            torch.cuda.synchronize()
    fam = {"convolutions": 0.0, "pooling": 0.0, "bn_act_fwd": 0.0, "bn_act_bwd": 0.0,
           "other": 0.0}
    fb_kernels = _kernel_times(fb)
    for name, ms in fb_kernels:
        key = name.lower()
        if "bn_fwd_" in key:
            fam["bn_act_fwd"] += ms
        elif "bn_bwd_" in key:
            fam["bn_act_bwd"] += ms
        elif "pool" in key:  # before CONV_MARKS: the pooling kernels' names hold "nhwc"
            fam["pooling"] += ms
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
        inputs, labels, _, _ = net._batch(MultiDataSet([x], [y]))
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


def _bn_kernel_entry(name, rows, launches, split_rows):
    """The kernels-line entry of bn_act_fwd or bn_act_bwd: numbers at the
    stem shape in bf16, max error over every case, its first design's time
    (both were redesigned) and every other case's; ``launches`` by path
    (the training, checkpoint, checkpoint_overhead, yolo_training,
    facenet_training, zoo, layer_families, data_tier, fused_update,
    transfer_learning, fit_featurized, cloud_checkpoint, supervised,
    parallel_training (parallel, parallel_compressed), elastic,
    data_parallel_world2 (the split calls of both ranks), model_parallel,
    perf_tier, keras_resnet50 and keras_cnn phases); ``split``: the split launches at res2 bf16 +res, their first
    design (csrc/bn_act_split_v1.cu) on the same operands as
    ``previous_ms``, the one launch's time, each entry's time, the split's
    floor and the other SPLIT_CASES."""
    kind = name[-3:]
    keys = ("ms", "host_ms", "previous_ms", "one_launch_ms", "plain_ms", "bound_ms",
            "bound_by", "floor_ms", "library_ms", "sync_library_ms")
    head = split_rows[0]
    split = {"shape": {k: head[k] for k in ("case", "rows", "channels", "dtype", "act",
                                            "residual")},
             **{k: head[kind][k] for k in keys},
             "entries": {k: v for k, v in head["entries"].items()
                         if k.startswith(kind)},
             "max_abs_err": max(r[kind]["max_abs_err"] for r in split_rows),
             "other_shapes": [dict({k: r[k] for k in ("case", "rows", "channels", "dtype",
                                                      "act", "residual")},
                                   **{k: r[kind][k] for k in keys},
                                   entries={k: v for k, v in r["entries"].items()
                                            if k.startswith(kind)})
                              for r in split_rows[1:]]}
    stem = next(r[kind] for r in rows if r["case"] == "stem" and r["dtype"] == "bfloat16")
    extra = {
        "previous_ms": stem["previous_ms"],
        "other_shapes": [{k: r[kind][k] for k in ("case", "rows", "channels", "dtype", "act",
                                                  "residual", "ms", "host_ms", "previous_ms",
                                                  "plain_ms", "bound_ms", "library_ms",
                                                  "sync_library_ms")}
                         for r in rows if r[kind] is not stem]}
    return {"name": name, "route": "cuda",
            "source": f"deeplearning4j_tpu_torch/csrc/{name}.cu",
            "replaces": "deeplearning4j_tpu/perf/pallas/bn.py:"
                        + ("88" if kind == "fwd" else "169"),
            "launches": sum(launches.values()), "launches_by_path": launches,
            "max_abs_err": stem["max_abs_err"],
            "max_abs_err_all_cases": max(r[kind]["max_abs_err"] for r in rows),
            "ms": stem["ms"], "host_ms": stem["host_ms"], "plain_ms": stem["plain_ms"],
            "bound_ms": stem["bound_ms"], "bound_by": stem["bound_by"],
            "library_ms": stem["library_ms"], "sync_library_ms": stem["sync_library_ms"],
            "shape": {"rows": stem["rows"], "channels": stem["channels"],
                      "dtype": "bfloat16"}, **extra, "split": split}


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


def first_design_adc_pq(torch, lut, codes):
    """adc_pq's first design (about 2,048 blocks, each staging its query
    group's LUT) on the same operands."""
    import ctypes

    from deeplearning4j_tpu_torch.perf.kernels import adc
    P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    fn = _first_design("adc_pq", [P, P, P, I, L, I, I, I])
    b, m_count, ksub = lut.shape
    d2 = torch.empty((b, codes.shape[0]), dtype=torch.float32, device=lut.device)
    err = fn(lut.data_ptr(), codes.data_ptr(), d2.data_ptr(), b, codes.shape[0], m_count, ksub,
             adc._vec8(codes), torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"adc_pq_v1 launch failed with CUDA error {err}")
    return d2


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
    wrapper_host_ms = host_ms(torch, lambda: adc.adc_pq(lut, codes))
    previous_ms = time_ms(torch, lambda: first_design_adc_pq(torch, lut, codes), flush)
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
           "max_abs_err": err, "ms": ms, "host_ms": wrapper_host_ms, "previous_ms": previous_ms,
           "plain_ms": plain_ms, "bound_ms": bound_ms,
           "bound_by": bound_by, "library_ms": library_ms,
           "library": "F.embedding_bag(mode='sum')", "library_max_abs_diff": lib_diff,
           "lut_gathers": b * n * m_count}
    print("adc_pq " + json.dumps(row), flush=True)
    return row


def first_design_adc_ivf_pq(torch, lut, codes, seg, pos):
    """adc_ivf_pq's first design (one block per query and slot tile, each
    staging its query's whole LUT) on the same operands."""
    from deeplearning4j_tpu_torch.perf.kernels import adc
    fn = _first_design("adc_ivf_pq", adc._ARGTYPES["adc_ivf_pq"][:-1])
    lut, codes, seg, pos = (v.contiguous() for v in (lut, codes, seg, pos))  # as the wrapper
    b, p, m_count, ksub = lut.shape
    d2 = torch.empty(seg.shape, dtype=torch.float32, device=lut.device)
    err = fn(lut.data_ptr(), codes.data_ptr(), seg.data_ptr(), pos.data_ptr(), d2.data_ptr(),
             b, seg.shape[1], p, m_count, ksub, codes.shape[0], adc._vec8(codes),
             torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"adc_ivf_pq_v1 launch failed with CUDA error {err}")
    return d2


def adc_ivf_bound(b, c, p, m_count, ksub, n_valid):
    """(ms, "bytes"|"operations"): each slot reads seg and pos and writes d2
    (12 B), each valid slot reads its M code bytes, each query's LUT is read
    once; n_valid * M float32 adds."""
    return bytes_ops_bound(12 * b * c + n_valid * m_count + 4 * b * p * m_count * ksub,
                           n_valid * m_count, PEAK_F32_OPS_PER_S)


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
    first = first_design_adc_ivf_pq(torch, *args)
    torch.cuda.synchronize()
    if not torch.equal(got.view(torch.int32), first.view(torch.int32)):
        raise AssertionError(f"adc_ivf_pq {label} b={b}: differs from its first design")
    del first
    ms = time_ms(torch, lambda: adc.adc_ivf_pq(*args), flush)
    wrapper_host_ms = host_ms(torch, lambda: adc.adc_ivf_pq(*args))
    previous_ms = time_ms(torch, lambda: first_design_adc_ivf_pq(torch, *args), flush)
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
    bound_ms, bound_by = adc_ivf_bound(b, c, p, m_count, ksub, n_valid)
    row = {"case": label, "b": b, "C": c, "p": p, "M": m_count, "ksub": ksub,
           "valid_slots": n_valid, "global_lut": 4 * p * m_count * ksub > 232448,
           "max_abs_err": err, "ms": ms, "host_ms": wrapper_host_ms,
           "previous_ms": previous_ms, "plain_ms": plain_ms,
           "bound_ms": bound_ms,
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
    # the corpus, queries, exact ids and the PQ and IVF-PQ indexes stay for
    # the serving-tier phases (26 and 29), which serve them as built here
    kept = {"V": V, "Q": Q, "exact_ids": exact, "pq": ix["pq"], "ivf_pq": ix["ivf_pq"]}
    del ix
    torch.cuda.empty_cache()
    print(f"retrieval phase ran {time.perf_counter() - t_phase:.1f} s", flush=True)
    return pq_rows, ivf_rows, int4_rows, served, kept



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


def first_design_scatter(torch, table, rows32, perm32, grads):
    """scatter_add's first design (one warp per segment) on the same sorted
    work, its rows and perm cast to int32 as it takes them."""
    import ctypes
    P, I = ctypes.c_void_p, ctypes.c_int
    fn = _first_design("scatter_add", [P, P, P, P, ctypes.c_longlong, I, I, I])
    v, d = table.shape
    vec = int(d % 4 == 0 and table.data_ptr() % 16 == 0 and grads.data_ptr() % 16 == 0)
    err = fn(table.data_ptr(), rows32.data_ptr(), perm32.data_ptr(), grads.data_ptr(),
             rows32.shape[0], v, d, vec, torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"scatter_add_v1 launch failed with CUDA error {err}")
    return table


def scatter_case(torch, flush, table, idx, grads, label) -> dict:
    """Hold scatter_add bitwise against its plain version and itself, and
    time the kernel alone (on sorted work), its first design on the same
    work, the sort alone, the sort + kernel wrapper, the plain version and
    Tensor.index_add_ beside the bound."""
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
    rows32, perm32 = rows.to(torch.int32), perm.to(torch.int32)
    t = table.clone()
    ms = time_ms(torch, lambda: sa.launch_sorted(t, rows, perm, grads), flush)
    previous_ms = time_ms(torch, lambda: first_design_scatter(torch, t, rows32, perm32, grads),
                          flush)
    sort_ms = time_ms(torch, lambda: torch.sort(idx, stable=True), flush)
    wrapper_ms = time_ms(torch, lambda: sa.scatter_add(t, idx, grads), flush)
    wrapper_host_ms = host_ms(torch, lambda: sa.scatter_add(t, idx, grads))
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
           "previous_ms": previous_ms, "sort_ms": sort_ms,
           "wrapper_ms": wrapper_ms, "host_ms": wrapper_host_ms, "plain_ms": plain_ms,
           "plain_reps": plain_reps,
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


def _scatter_kernel_entry(rows, summary, graph_launches):
    """The kernels-line entry of scatter_add: numbers at the corpus path's
    contexts shape (N = 8192, D = 128), the two other per-batch shapes
    beside, max error over every case; launches by path (the Word2Vec
    phase's timed fit, DeepWalk's and Node2Vec's fits)."""
    head = {r["case"]: r for r in rows}
    main = head["corpus_contexts"]
    by_path = {"word2vec": summary["scatter_add_launches"], **graph_launches}
    return {"name": "scatter_add", "route": "cuda",
            "source": "deeplearning4j_tpu_torch/csrc/scatter_add.cu",
            "replaces": "deeplearning4j_tpu/nlp/pallas_scatter.py:35",
            "launches": sum(by_path.values()), "launches_by_path": by_path,
            "max_abs_err": max(r["max_abs_err"] for r in rows),
            "ms": main["ms"], "previous_ms": main["previous_ms"],
            "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
            "bound_by": main["bound_by"], "library_ms": main["library_ms"],
            "wrapper_ms": main["wrapper_ms"], "host_ms": main["host_ms"],
            "sort_ms": main["sort_ms"],
            "shape": {k: main[k] for k in ("V", "D", "N")},
            "other_main_path_shapes": {c: {k: head[c][k] for k in (
                "N", "ms", "previous_ms", "wrapper_ms", "sort_ms", "plain_ms", "bound_ms",
                "library_ms")} for c in ("corpus_centers", "corpus_negatives")},
            "other_shapes": [{k: r[k] for k in ("case", "D", "N", "longest_chain", "ms",
                                                "previous_ms", "library_ms")}
                             for r in rows if not r["case"].startswith("corpus_")]}

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
    wrapper_host_ms = host_ms(torch, lambda: fa.flash_attention(q, k, v, causal=causal))
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
           "max_abs_v": vmax, "ms": ms, "host_ms": wrapper_host_ms, "previous_ms": previous_ms,
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
            "ms": main["ms"], "host_ms": main["host_ms"], "previous_ms": main["previous_ms"],
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


def first_design_flash_bwd_dkv(torch, q, k, v, do, lse, delta, causal):
    """flash_attn_bwd_dkv's first design (float32 CUDA-core tiles for both
    dtypes) on the same operands."""
    import ctypes
    fn = _first_design("flash_attn_bwd_dkv", [ctypes.c_void_p] * 9 + [ctypes.c_int] * 6,
                       "flash_attn_bwd_v1")
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    b, h, t, d = q.shape
    strides = (ctypes.c_longlong * 18)(*(x for a in (q, k, v, do, dk, dv)
                                         for x in a.stride()[:3]))
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
             delta.data_ptr(), dk.data_ptr(), dv.data_ptr(), ctypes.addressof(strides), b, h, t,
             d, int(q.dtype == torch.bfloat16), int(causal),
             torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"flash_attn_bwd_dkv_v1 launch failed with CUDA error {err}")
    return dk, dv


def first_design_flash_bwd_dq(torch, q, k, v, do, lse, delta, causal):
    """flash_attn_bwd_dq's first design (float32 CUDA-core tiles for both
    dtypes) on the same operands."""
    import ctypes
    fn = _first_design("flash_attn_bwd_dq", [ctypes.c_void_p] * 8 + [ctypes.c_int] * 6)
    dq = torch.empty_like(q)
    b, h, t, d = q.shape
    strides = (ctypes.c_longlong * 15)(*(x for a in (q, k, v, do, dq) for x in a.stride()[:3]))
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
             delta.data_ptr(), dq.data_ptr(), ctypes.addressof(strides), b, h, t, d,
             int(q.dtype == torch.bfloat16), int(causal), torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"flash_attn_bwd_dq_v1 launch failed with CUDA error {err}")
    return dq


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
        first = first_design_flash_bwd_dkv if name.endswith("dkv") else first_design_flash_bwd_dq
        timed = {"ms": time_ms(torch, lambda: kernel(q, k, v, do, lse, delta, causal), flush),
                 "host_ms": host_ms(torch, lambda: kernel(q, k, v, do, lse, delta, causal)),
                 "previous_ms": time_ms(torch, lambda: first(torch, q, k, v, do, lse, delta,
                                                             causal), flush)}
        plain_ms = time_ms(torch, lambda: plain(q, k, v, do, lse, delta, causal), flush)
        products, outputs = (4, 2) if name.endswith("dkv") else (3, 1)
        bound_ms, bound_by = bytes_ops_bound(
            io + outputs * b * h * t * d * q.element_size(),
            products * 2.0 * b * h * pairs * d, peak)
        row[name] = {"max_abs_err": max(errs), "max_err_over_limit": max(overs),
                     "limits": limits, **timed, "plain_ms": plain_ms,
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


def char_rnn_data(torch, dev, windows: int, seed: int):
    """bench.py bench_graveslstm's data: one-hot characters and one-hot
    labels of CHAR_BATCH sequences of CHAR_T * windows steps, drawn by
    numpy.random.default_rng(seed)."""
    rng = np.random.default_rng(seed)
    eye = np.eye(CHAR_VOCAB, dtype=np.float32)
    shape = (CHAR_BATCH, CHAR_T * windows)
    x = eye[rng.integers(0, CHAR_VOCAB, shape)]
    y = eye[rng.integers(0, CHAR_VOCAB, shape)]
    return torch.from_numpy(x).to(dev), torch.from_numpy(y).to(dev)


def char_window_profile(torch, net, batch, window_ms) -> dict:
    """One tBPTT window (forward, backward, RmsProp) under torch.profiler,
    from zero carries; ``batch`` is what ``net._train_step`` takes before
    the carries (inputs, labels, masks). The second of two runs, the first
    paying the tracer's start-up: device busy time (the union of the device
    spans), the traced wall, the idle share against it and against the
    median unprofiled window, the host's kernel launch calls, the top
    kernels."""
    from torch.profiler import ProfilerActivity, profile

    x = batch[0][0] if isinstance(batch[0], list) else batch[0]
    for _ in range(2):
        carries = net._zero_carries(int(x.shape[0]))
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            net._train_step(*batch, carries=carries)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
    spans = _device_spans(prof)
    if not spans:
        raise AssertionError("char_rnn: the profile recorded no device activity")
    busy = _union_ms(spans)
    return {"device_busy_ms": busy, "wall_ms": wall_ms, "idle_share": 1.0 - busy / wall_ms,
            "median_window_ms_unprofiled": window_ms,
            "idle_share_vs_unprofiled_window": 1.0 - busy / window_ms,
            "device_events": len(spans),
            "host_kernel_launch_calls": sum(1 for evt in prof.events()
                                            if "LaunchKernel" in evt.name),
            "top_kernels_ms": [[name[:70], ms] for name, ms in _kernel_times(prof)[:8]]}


def char_rnn_phase(torch, dev, card) -> dict:
    """The char-RNN of bench.py bench_graveslstm at full width
    (TextGenerationLSTM: two GravesLSTM(256) and a 47-way softmax, RmsProp
    1e-2, weights from its seed) trained through MultiLayerNetwork.fit with
    tBPTT 50: a CHAR_WARM-window sequence to warm up, then one timed
    sequence of CHAR_WINDOWS windows (batch 64 x 1,500 characters). Each
    window's device-clock start is marked by a CUDA event; chars/s is
    bench.py's (batch x sequence length over the fit's wall time). Held:
    CHAR_WINDOWS updater steps, every loss finite, the last below the first,
    no kernel of the port launched (the recurrent path runs no TPU
    kernel). Then one window profiled, and CHAR_STEPS single rnn_time_step
    calls after rnn_clear_previous_state against the stateless forward of
    the same prefix, within CHAR_STEP_ATOL."""
    from deeplearning4j_tpu_torch.datasets import DataSet
    from deeplearning4j_tpu_torch.models import TextGenerationLSTM

    t_phase = time.perf_counter()
    net = TextGenerationLSTM(total_unique_characters=CHAR_VOCAB,
                             tbptt_length=CHAR_T).init(dev)
    xw, yw = char_rnn_data(torch, dev, CHAR_WARM, seed=1)
    x, y = char_rnn_data(torch, dev, CHAR_WINDOWS, seed=0)
    _zero_launch_counts()
    net.fit(DataSet(xw, yw))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    marks, first_iteration = [], net.iteration
    t0 = time.perf_counter()
    losses = _fit_windows(torch, net, x, y, marks)
    marks.append(torch.cuda.Event(enable_timing=True))
    marks[-1].record()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    windows = net.iteration - first_iteration
    window_ms = [a.elapsed_time(b) for a, b in zip(marks, marks[1:])]
    losses = [float(v) for v in losses]
    if windows != CHAR_WINDOWS or len(losses) != CHAR_WINDOWS:
        raise AssertionError(f"char_rnn: {windows} updater steps, want {CHAR_WINDOWS}")
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"char_rnn: losses {losses}")
    if any(_launch_counts().values()):
        raise AssertionError(f"char_rnn launched a kernel of the port: {_launch_counts()}")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    median_ms = float(np.median(window_ms))
    prof = char_window_profile(torch, net, (x[:, :CHAR_T], y[:, :CHAR_T], None, None),
                               median_ms)
    net.rnn_clear_previous_state()
    steps = torch.stack([net.rnn_time_step(x[:, i]) for i in range(CHAR_STEPS)], dim=1)
    full = net.output(x[:, :CHAR_STEPS])
    step_err = float((steps - full).abs().max())
    if not step_err <= CHAR_STEP_ATOL or steps.shape != (CHAR_BATCH, CHAR_STEPS, CHAR_VOCAB):
        raise AssertionError(f"char_rnn: rnn_time_step {tuple(steps.shape)} differs from "
                             f"the stateless forward by {step_err} > {CHAR_STEP_ATOL}")
    summary = {"card": card, "batch": CHAR_BATCH, "tbptt": CHAR_T, "windows": windows,
               "sequence_length": CHAR_T * CHAR_WINDOWS, "params": net.num_params(),
               "chars_per_s": CHAR_BATCH * CHAR_T * CHAR_WINDOWS / wall, "fit_s": wall,
               "median_window_ms": median_ms, "window_ms_min_max": [min(window_ms),
                                                                   max(window_ms)],
               "first_loss": losses[0], "last_loss": losses[-1], "losses": losses,
               "peak_gb": peak_gb, "window_profile": prof,
               "rnn_time_step": {"steps": CHAR_STEPS, "max_abs_err": step_err,
                                 "limit": CHAR_STEP_ATOL}}
    print("char_rnn " + json.dumps(summary), flush=True)
    print(f"char_rnn phase ran {time.perf_counter() - t_phase:.1f} s", flush=True)
    return summary


def _fit_windows(torch, net, x, y, marks=None, mask=None) -> list:
    """``net.fit`` on one sequence batch (``mask`` its features and labels
    mask): each tBPTT window's loss (a tensor, read without a synchronise),
    and with ``marks`` a CUDA event recorded at each window's start."""
    from deeplearning4j_tpu_torch.datasets import DataSet

    losses, step = [], net._train_step

    def noting(*args, **kw):
        if marks is not None:
            marks.append(torch.cuda.Event(enable_timing=True))
            marks[-1].record()
        out = step(*args, **kw)
        losses.append(net._score)
        return out

    net._train_step = noting
    try:
        m = None if mask is None else mask.to(net.device, x.dtype)
        net.fit(DataSet(x.to(net.device), y.to(net.device), m, m))
    finally:
        del net._train_step
    return losses


def char_graph_conf():
    """The char-RNN of phase 15 built with GraphBuilder: input -> GravesLSTM
    l1 -> GravesLSTM l2 -> 47-way RnnOutputLayer out, the same seed,
    updater, init and tBPTT as TextGenerationLSTM's."""
    from deeplearning4j_tpu_torch.nn.conf.graph import GraphBuilder
    from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
    from deeplearning4j_tpu_torch.nn.conf.network import NeuralNetConfiguration
    from deeplearning4j_tpu_torch.nn.conf.recurrent import GravesLSTM, RnnOutputLayer
    from deeplearning4j_tpu_torch.optimize.updaters import RmsProp

    parent = (NeuralNetConfiguration.builder().seed(12345)
              .updater(RmsProp(learning_rate=1e-2)).weight_init("xavier"))
    return (GraphBuilder(parent).add_inputs("in")
            .add_layer("l1", GravesLSTM(n_out=256, activation="tanh"), "in")
            .add_layer("l2", GravesLSTM(n_out=256, activation="tanh"), "l1")
            .add_layer("out", RnnOutputLayer(n_out=CHAR_VOCAB, activation="softmax",
                                             loss="mcxent"), "l2")
            .set_outputs("out").set_input_types(InputType.recurrent(CHAR_VOCAB))
            .backprop_type("tbptt", fwd_length=CHAR_T, back_length=CHAR_T).build())


def char_mask(torch, dev, rng, low: int, steps: int):
    """(CHAR_BATCH, steps) float32 prefix mask, each row's length drawn by
    ``rng`` in [low, steps]."""
    lengths = torch.from_numpy(rng.integers(low, steps + 1, CHAR_BATCH))
    return (torch.arange(steps)[None, :] < lengths[:, None]).float().to(dev)


def graph_char_rnn_phase(torch, dev, card) -> dict:
    """The char-RNN as a ComputationGraph at full width, trained on text of
    uneven length: features and labels masks give each of the 64 rows a
    length from numpy.random.default_rng(1) in [750, 1500]. Both the graph
    and the MultiLayerNetwork of phase 15 start from the same weights, take
    CHAR_WARM unmasked warm-up windows, then fit the same masked 30-window
    sequence. Held: the same window losses and every parameter bitwise (the
    two networks run the same operations on the same tensors in the same
    order), every loss finite, no kernel of the port launched. chars/s
    counts the unmasked characters over the graph's fit; the window ms come
    from CUDA events; one masked graph window is profiled. Then 10
    rnn_time_step calls on the graph against its stateless forward of the
    prefix within CHAR_STEP_ATOL, and the masked 2-window card-against-CPU
    fit (char_rnn_card_vs_cpu with graph=True)."""
    from deeplearning4j_tpu_torch.models import TextGenerationLSTM
    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork

    t_phase = time.perf_counter()
    mln = MultiLayerNetwork(TextGenerationLSTM(total_unique_characters=CHAR_VOCAB,
                                               tbptt_length=CHAR_T).conf(), dev).init()
    net = ComputationGraph(char_graph_conf(), dev)
    net.set_params({n: {k: v.clone() for k, v in p.items()}
                    for n, p in zip(("l1", "l2", "out"), mln.params)},
                   {n: {} for n in net.order})
    xw, yw = char_rnn_data(torch, dev, CHAR_WARM, seed=1)
    x, y = char_rnn_data(torch, dev, CHAR_WINDOWS, seed=0)
    steps = CHAR_T * CHAR_WINDOWS
    mask = char_mask(torch, dev, np.random.default_rng(1), GRAPH_CHAR_MIN, steps)
    _zero_launch_counts()
    for n in (net, mln):
        _fit_windows(torch, n, xw, yw)
    torch.cuda.synchronize()
    marks = []
    t0 = time.perf_counter()
    losses = _fit_windows(torch, net, x, y, marks, mask=mask)
    marks.append(torch.cuda.Event(enable_timing=True))
    marks[-1].record()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    mln_losses = _fit_windows(torch, mln, x, y, mask=mask)
    torch.cuda.synchronize()
    if any(_launch_counts().values()):
        raise AssertionError(f"graph_char_rnn launched a kernel of the port: "
                             f"{_launch_counts()}")
    losses, mln_losses = [float(v) for v in losses], [float(v) for v in mln_losses]
    if len(losses) != CHAR_WINDOWS or not all(np.isfinite(losses)):
        raise AssertionError(f"graph_char_rnn: losses {losses}")
    if losses != mln_losses:
        raise AssertionError(f"graph_char_rnn: window losses differ from the "
                             f"MultiLayerNetwork's: {losses} vs {mln_losses}")
    differ = [f"{n}/{k}" for n, p in zip(("l1", "l2", "out"), mln.params)
              for k, v in p.items() if not torch.equal(v, net.params[n][k])]
    if differ:
        raise AssertionError(f"graph_char_rnn: parameters differ from the "
                             f"MultiLayerNetwork's: {differ}")
    del mln
    window_ms = [a.elapsed_time(b) for a, b in zip(marks, marks[1:])]
    median_ms = float(np.median(window_ms))
    prof = char_window_profile(torch, net, ([x[:, :CHAR_T]], [y[:, :CHAR_T]],
                                            [mask[:, :CHAR_T]], [mask[:, :CHAR_T]]),
                               median_ms)
    net.rnn_clear_previous_state()
    stepped = np.stack([net.rnn_time_step(x[:, i])[0] for i in range(CHAR_STEPS)], axis=1)
    full = net.output_single(x[:, :CHAR_STEPS])
    step_err = float(np.abs(stepped - full).max())
    if not step_err <= CHAR_STEP_ATOL or stepped.shape != (CHAR_BATCH, CHAR_STEPS,
                                                           CHAR_VOCAB):
        raise AssertionError(f"graph_char_rnn: rnn_time_step {stepped.shape} differs from "
                             f"the stateless forward by {step_err} > {CHAR_STEP_ATOL}")
    chars = int(mask.sum())
    summary = {"card": card, "batch": CHAR_BATCH, "tbptt": CHAR_T, "windows": len(losses),
               "sequence_length": steps, "unmasked_chars": chars,
               "row_lengths_min_max": [int(mask.sum(1).min()), int(mask.sum(1).max())],
               "chars_per_s": chars / wall, "fit_s": wall,
               "median_window_ms": median_ms,
               "window_ms_min_max": [min(window_ms), max(window_ms)],
               "first_loss": losses[0], "last_loss": losses[-1],
               "equals_multilayer_bitwise": True, "window_profile": prof,
               "rnn_time_step": {"steps": CHAR_STEPS, "max_abs_err": step_err,
                                 "limit": CHAR_STEP_ATOL}}
    print("graph_char_rnn " + json.dumps(summary), flush=True)
    del net
    char_rnn_card_vs_cpu(torch, dev, graph=True)
    print(f"graph_char_rnn phase ran {time.perf_counter() - t_phase:.1f} s", flush=True)
    return summary


# ------------------------------------------------------------ checkpoints
def resnet50_train_conf(updater=None):
    """The training phase's network: ResNet50 at 224x224x3, 1000 classes,
    bf16 compute on float32 masters, conf.fused(); Adam 1e-3 by default."""
    import dataclasses

    from deeplearning4j_tpu_torch.models import ResNet50

    conf = ResNet50(num_classes=1000, input_shape=(TRAIN_SIDE, TRAIN_SIDE, 3),
                    updater=updater).conf()
    return dataclasses.replace(conf, dtype="bfloat16").fused()


def ckpt_batches(torch, dev):
    """CKPT_BATCHES distinct batches of TRAIN_BATCH images and one-hot labels,
    drawn on the card from a seeded torch.Generator."""
    from deeplearning4j_tpu_torch.datasets import DataSet

    gen = torch.Generator(device=dev)
    gen.manual_seed(20)
    eye = torch.eye(1000, device=dev)
    return [DataSet(torch.randn((TRAIN_BATCH, TRAIN_SIDE, TRAIN_SIDE, 3), generator=gen,
                                device=dev),
                    eye[torch.randint(0, 1000, (TRAIN_BATCH,), generator=gen, device=dev)])
            for _ in range(CKPT_BATCHES)]


def _run_record(net) -> dict:
    """A finished host copy of what a run ends with: masters, running
    stats, updater state, the dropout and augmentation generators,
    iteration and epoch."""
    from deeplearning4j_tpu_torch.utils.serialization import snapshot_training_state

    snap = snapshot_training_state(net)
    arrays = {f"coefficients:{k}": v for k, v in snap["coefficients"].items()}
    arrays.update({f"updater:{k}": np.asarray(v) for k, v in snap["updater_state"].items()})
    gen = snap["generator"]
    return {"arrays": arrays, "generator": np.concatenate([gen["state"], gen["augment_state"]]),
            "counters": [snap["iteration"], snap["epoch"]]}


def _differences(a, b) -> list:
    """What differs between two run records, bit for bit: (name, max |diff|)."""
    out = []
    for k, v in a["arrays"].items():
        w = b["arrays"][k]
        if v.shape != w.shape or v.tobytes() != w.tobytes():
            out.append((k, float(np.abs(v.astype(np.float64) - w.astype(np.float64)).max())))
    if a["generator"].tobytes() != b["generator"].tobytes():
        out.append(("generator", None))
    if a["counters"] != b["counters"]:
        out.append(("counters", [a["counters"], b["counters"]]))
    return out


def checkpoint_phase(torch, dev, card, workdir) -> dict:
    """Crash-exact resume of ResNet50 training at full width (the training
    phase's network and updater), tests/test_checkpoint.py:80-111's schedule:
    5 distinct batches of 128 drawn on the card, 2 epochs through
    ComputationGraph.fit, under cudnn.deterministic (benchmark off; both
    put back after). Held, bit for bit (masters, BN running stats, Adam
    state, iteration, epoch, the dropout generator):
    1. two uninterrupted runs from one seed agree (the determinism control);
    2. CheckpointManager(save_every_n_steps=3) with FaultInjector(kill_at_step=7)
       raises SimulatedCrash;
    3. a fresh manager's restore_latest() comes back at (6, 1, 1);
    4. the resumed fit (checkpointing on) ends equal to the uninterrupted run;
    controls that must miss: the same resume with load_updater=False, and
    one whose skip of the consumed batches is bypassed. Then the resumed
    network is written with write_model (for the serialization phase), and
    tear_file on the newest checkpoint (step 9, from the resumed run) makes
    restore_latest fall back to step 6. bn_act_fwd and bn_act_bwd launch 53
    times a step. One ResNet50 lives on the card at a time."""
    from deeplearning4j_tpu_torch.checkpoint import (CheckpointManager, FaultInjector,
                                                     SimulatedCrash, tear_file)
    from deeplearning4j_tpu_torch.checkpoint.sharded import state_sha
    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
    from deeplearning4j_tpu_torch.perf.kernels import bn_act
    from deeplearning4j_tpu_torch.utils.serialization import write_model

    t_phase = time.perf_counter()
    conf = resnet50_train_conf()
    batches = ckpt_batches(torch, dev)
    ck = os.path.join(workdir, "ckpt")
    steps = 0

    def fit(net, cm=None):
        nonlocal steps
        i0 = net.iteration
        try:
            net.fit(batches, num_epochs=CKPT_EPOCHS, checkpoint_manager=cm)
        except SimulatedCrash:
            steps += net.iteration - i0 + 1  # the crash step updated, uncounted
            raise
        steps += net.iteration - i0
        return net

    flags = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    bn_act.fwd_launches = bn_act.bwd_launches = 0
    try:
        runs, shas = [], []
        for _ in range(2):
            net = fit(ComputationGraph(conf, dev).init())
            runs.append(_run_record(net))
            shas.append(state_sha(net))
            del net
            torch.cuda.empty_cache()
        diff = _differences(*runs)
        if diff or shas[0] != shas[1]:
            raise AssertionError(f"checkpoint: two uninterrupted runs from one seed differ in "
                                 f"{len(diff)} arrays (determinism control): {diff[:12]}")
        ref = runs.pop()
        cm = CheckpointManager(ck, save_every_n_steps=CKPT_EVERY, device=dev)
        net = ComputationGraph(conf, dev).init().set_listeners(
            FaultInjector(kill_at_step=CKPT_KILL))
        try:
            fit(net, cm)
            raise AssertionError("checkpoint: the injected crash did not fire")
        except SimulatedCrash:
            pass
        cm.close()
        del net
        torch.cuda.empty_cache()
        saved = [(e["step"], e["size"]) for e in CheckpointManager(ck, device=dev).checkpoints()]
        controls = {}
        for name in ("without_updater_state", "without_skip"):
            net = CheckpointManager(ck, device=dev).restore_latest(
                load_updater=name != "without_updater_state")
            if name == "without_skip":
                net._resume_state.batch_in_epoch = 0
            diff = _differences(ref, _run_record(fit(net)))
            del net
            torch.cuda.empty_cache()
            if not diff:
                raise AssertionError(f"checkpoint: the control {name} matches the "
                                     "uninterrupted run")
            controls[name] = {"arrays_differing": len(diff), "first": diff[:3]}
        cm2 = CheckpointManager(ck, save_every_n_steps=CKPT_EVERY, device=dev)
        t0 = time.perf_counter()
        resumed = cm2.restore_latest()
        restore_s = time.perf_counter() - t0
        rs = resumed._resume_state
        if (rs.step, rs.epoch, rs.batch_in_epoch) != CKPT_RESTORED:
            raise AssertionError(f"checkpoint: restore_latest came back at "
                                 f"{(rs.step, rs.epoch, rs.batch_in_epoch)}, want "
                                 f"{CKPT_RESTORED}")
        fit(resumed, cm2)
        cm2.close()
        diff = _differences(ref, _run_record(resumed))
        if diff:
            raise AssertionError(f"checkpoint: the resumed run differs from the "
                                 f"uninterrupted one in {len(diff)} arrays: {diff[:12]}")
        model_zip = os.path.join(workdir, "resnet50.zip")
        t0 = time.perf_counter()
        write_model(resumed, model_zip)
        write_s = time.perf_counter() - t0
        del resumed
        torch.cuda.empty_cache()
        cm3 = CheckpointManager(ck, device=dev)
        newest = cm3.checkpoints()[-1]
        tear_file(os.path.join(ck, newest["file"]))
        back = cm3.restore_latest()
        fallback = (newest["step"], back._resume_state.step)
        del back
        if fallback != (CKPT_RESTORED[0] + CKPT_EVERY, CKPT_RESTORED[0]):
            raise AssertionError(f"checkpoint: torn step {fallback[0]} fell back to "
                                 f"{fallback[1]}")
        fwd, bwd = bn_act.fwd_launches, bn_act.bwd_launches
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = flags
        torch.cuda.empty_cache()
    if not fwd == bwd == RESNET50_FUSED_BLOCKS * steps:
        raise AssertionError(f"checkpoint: bn_act launched {fwd} forward / {bwd} backward "
                             f"in {steps} steps; want {RESNET50_FUSED_BLOCKS * steps} each")
    summary = {"card": card, "batches": CKPT_BATCHES, "batch": TRAIN_BATCH,
               "epochs": CKPT_EPOCHS, "save_every_n_steps": CKPT_EVERY,
               "kill_at_step": CKPT_KILL, "determinism_control": "bitwise",
               "restored": list(CKPT_RESTORED), "resume": "bitwise",
               "compared_arrays": len(ref["arrays"]), "controls_missed": controls,
               "checkpoints": saved, "checkpoint_bytes": saved[-1][1],
               "restore_latest_s": restore_s, "torn_newest_fell_back": list(fallback),
               "write_model_s": write_s, "steps": steps,
               "bn_act_fwd_launches": fwd, "bn_act_bwd_launches": bwd,
               "seconds": time.perf_counter() - t_phase}
    print("checkpoint " + json.dumps(summary), flush=True)
    return {"fwd": fwd, "bwd": bwd, "model_zip": model_zip, "record": ref,
            "write_s": write_s, "state_sha": shas[0]}


def serialization_phase(torch, dev, card, ckpt) -> dict:
    """The resumed ResNet50 of the checkpoint phase, written by
    utils/serialization.write_model (ZIP_DEFLATED), restored with
    device="cpu" and on the card: masters, running stats and updater state
    bitwise equal to the trained network's on both. Then one seeded image
    through both restored networks' float32 inference forward (the card
    through the kernels, the CPU through the plain versions) and a float64
    CPU referee, under the card_vs_cpu phase's float32 limit on the logits:
    the card's distance to the referee within 3x the CPU float32 forward's,
    or 1e-3 of the largest logit."""
    import dataclasses

    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
    from deeplearning4j_tpu_torch.nn.tree import tree_map
    from deeplearning4j_tpu_torch.utils.serialization import restore

    path = ckpt["model_zip"]
    restored, seconds = {}, {}
    for label, where in (("cpu", "cpu"), ("card", dev)):
        t0 = time.perf_counter()
        net = restore(path, device=where)
        seconds[label] = time.perf_counter() - t0
        diff = [d for d in _differences(ckpt["record"], _run_record(net))
                if d[0] != "generator"]  # model zips carry no generator
        if diff:
            raise AssertionError(f"serialization: restored on {where} differs in "
                                 f"{len(diff)} arrays: {diff[:8]}")
        conf32 = dataclasses.replace(net.conf, dtype="float32")
        restored[label] = ComputationGraph(conf32, net.device).set_params(
            net.params, net.state)
        del net
    cpu = restored["cpu"]
    ref = ComputationGraph(dataclasses.replace(cpu.conf, dtype="float64"), "cpu").set_params(
        *(tree_map(lambda v: v.double(), t) for t in (cpu.params, cpu.state)))
    x = np.random.default_rng(3).standard_normal((1, TRAIN_SIDE, TRAIN_SIDE, 3),
                                                 dtype=np.float32)

    def logits(net, xs):
        """The output layer's pre-activation in inference mode (a trained
        net's softmax saturates: its probabilities would hide the error)."""
        with torch.no_grad():
            z = net._forward(net.params, net.state, [net._as_tensor(xs)], False)[1]
        return z[net.conf.network_outputs[0]].cpu().double().numpy()

    outs = {k: logits(n, x) for k, n in restored.items()}
    want = logits(ref, x.astype(np.float64))
    cpu_err = float(np.abs(outs["cpu"] - want).max())
    card_err = float(np.abs(outs["card"] - want).max())
    limit = max(3.0 * cpu_err, 1e-3 * float(np.abs(want).max()))
    if not card_err <= limit:
        raise AssertionError(f"serialization: card forward vs float64 {card_err} > {limit} "
                             f"(CPU float32 vs float64 {cpu_err})")
    del restored, cpu, ref
    torch.cuda.empty_cache()
    summary = {"card": card, "zip_bytes": os.path.getsize(path),
               "write_model_s": ckpt["write_s"], "restore_s": seconds,
               "restored": "bitwise on the CPU and the card",
               "logits": {"card_vs_f64": card_err, "cpu_vs_f64": cpu_err, "limit": limit,
                          "max_abs": float(np.abs(want).max())}}
    print("serialization " + json.dumps(summary), flush=True)
    return summary


def checkpoint_overhead_phase(torch, dev, card, workdir) -> dict:
    """bench.py bench_checkpoint at ResNet50 width: the training phase's
    network on one resident batch, OVERHEAD_STEPS steps through fit with
    checkpointing off, asynchronous every OVERHEAD_EVERY steps, synchronous
    every OVERHEAD_EVERY steps, and off again (the host's drift), each timed
    from an idle card to a synchronised end; overhead_async_pct as bench.py
    computes it, against the mean of the two off runs. Beside it: the
    snapshot's ms on the training thread, a plain pageable .cpu() copy of
    the same tensors timed once as the yardstick, the writer's commit ms
    (zip, sha256, write, manifest), and whether the bounded queue pushed
    back; the commit by part (zip bytes, sha256, storage write). The JAX
    bench's bar (< 10%) is printed, not gated."""
    import shutil

    from deeplearning4j_tpu_torch.checkpoint import CheckpointManager
    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
    from deeplearning4j_tpu_torch.nn.tree import tree_leaves
    from deeplearning4j_tpu_torch.perf.kernels import bn_act

    net = ComputationGraph(resnet50_train_conf(), dev).init()
    ds = ckpt_batches(torch, dev)[0]
    bn_act.fwd_launches = bn_act.bwd_launches = 0
    for _ in range(OVERHEAD_WARM):
        net.fit(ds)
    batches = [ds] * OVERHEAD_STEPS

    def step_ms(cm):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        net.fit(batches, checkpoint_manager=cm)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / OVERHEAD_STEPS

    modes = {}
    off = [step_ms(None)]
    for mode in ("async", "sync"):
        d = os.path.join(workdir, f"overhead_{mode}")
        cm = CheckpointManager(d, save_every_n_steps=OVERHEAD_EVERY, keep_last=3,
                               async_write=mode == "async", device=dev)
        ms = step_ms(cm)
        t0 = time.perf_counter()
        cm.flush()
        drain_ms = (time.perf_counter() - t0) * 1e3
        t = {k: list(v) for k, v in cm.timings.items()}
        modes[mode] = {"step_ms": ms, "saves": cm.saves_committed,
                       **{k: t[k] for k in ("snapshot_ms", "commit_ms", "zip_ms",
                                            "sha256_ms", "write_ms", "queue_wait_ms")},
                       "backpressure_waits": cm.backpressure_waits,
                       "drain_after_fit_ms": drain_ms,
                       "checkpoint_bytes": cm.checkpoints()[-1]["size"]}
        cm.close()
        shutil.rmtree(d, ignore_errors=True)
    off.append(step_ms(None))
    fwd, bwd = bn_act.fwd_launches, bn_act.bwd_launches
    steps = OVERHEAD_WARM + 4 * OVERHEAD_STEPS
    if not fwd == bwd == RESNET50_FUSED_BLOCKS * steps:
        raise AssertionError(f"checkpoint_overhead: bn_act launched {fwd} / {bwd} in "
                             f"{steps} steps")
    tensors = [t for t in tree_leaves([net.params, net.state, net.opt_state])
               if isinstance(t, torch.Tensor)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    host = [t.cpu() for t in tensors]
    pageable_ms = (time.perf_counter() - t0) * 1e3
    nbytes = sum(t.numel() * t.element_size() for t in host)
    del net, host
    torch.cuda.empty_cache()
    off_ms = float(np.mean(off))

    def overhead(ms):  # bench.py: (sps_off - sps) / sps_off
        return (1e3 / off_ms - 1e3 / ms) / (1e3 / off_ms) * 100

    summary = {"card": card, "steps": OVERHEAD_STEPS,
               "save_every_n_steps": OVERHEAD_EVERY, "off_step_ms": off,
               "async_step_ms": modes["async"]["step_ms"],
               "sync_step_ms": modes["sync"]["step_ms"],
               "overhead_async_pct": overhead(modes["async"]["step_ms"]),
               "overhead_sync_pct": overhead(modes["sync"]["step_ms"]),
               "bar_pct_not_gated": OVERHEAD_BAR_PCT,
               "snapshot_tensor_bytes": nbytes,
               "pageable_cpu_copy_ms": pageable_ms, "modes": modes,
               "bn_act_fwd_launches": fwd, "bn_act_bwd_launches": bwd}
    print("checkpoint_overhead " + json.dumps(summary), flush=True)
    return {"fwd": fwd, "bwd": bwd}


def _named(params) -> dict:
    """``{"<layer or vertex>/<name>": tensor}`` of a network's parameters."""
    items = params.items() if isinstance(params, dict) else enumerate(params)
    return {f"{n}/{k}": v for n, p in items for k, v in p.items()}


def char_rnn_card_vs_cpu(torch, dev, graph: bool = False) -> dict:
    """One CHAR_CHECK_WINDOWS-window tBPTT fit of the char-RNN at full width
    (batch 64, two windows of 50, RmsProp) from the same float32 weights,
    float32 on the card and on the CPU, and float64 on the CPU as the
    referee; TF32 off. With ``graph`` the net is the ComputationGraph of the
    same layers and the fit is masked (row lengths from
    numpy.random.default_rng(2) in [25, 100]: rows end in either window).
    Held: each window's loss, and every updated parameter tensor, within
    CHAR_CHECK_MULT times the CPU float32 run's distance to the referee, or
    CHAR_CHECK_FRAC of the referee's largest magnitude. Two controls on the
    card must miss a limit: the peepholes zeroed, and the carries dropped
    between the windows (each window fit as its own sequence from zero
    state)."""
    import dataclasses

    from deeplearning4j_tpu_torch.models import TextGenerationLSTM
    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu_torch.nn.tree import tree_map

    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    if graph:
        conf, cls = char_graph_conf(), ComputationGraph
    else:
        conf = TextGenerationLSTM(total_unique_characters=CHAR_VOCAB,
                                  tbptt_length=CHAR_T).conf()
        cls = MultiLayerNetwork
    start = tree_map(lambda v: v.cpu(), cls(conf, dev).init().params)
    x, y = char_rnn_data(torch, "cpu", CHAR_CHECK_WINDOWS, seed=11)
    steps = CHAR_T * CHAR_CHECK_WINDOWS
    mask = (char_mask(torch, "cpu", np.random.default_rng(2), CHAR_T // 2, steps)
            if graph else None)

    def build(device, dtype=torch.float32, params=start):
        c = conf if dtype == torch.float32 else dataclasses.replace(conf, dtype="float64")
        net = cls(c, device)
        moved = tree_map(lambda v: v.to(device, dtype, copy=True), params)
        # a graph's state is one (here empty) dict a vertex
        return net.set_params(moved, {n: {} for n in net.order}) if graph else \
            net.set_params(moved)

    def fit(device, dtype=torch.float32, params=start):
        net = build(device, dtype, params)
        return net, [float(v) for v in _fit_windows(torch, net, x.to(dtype), y.to(dtype),
                                                    mask=mask)]

    ref, l64 = fit("cpu", torch.float64)
    ref_p = _named(ref.params)
    cpu, l32 = fit("cpu")
    card, lg = fit(dev)

    def distances(net, losses):
        loss_d = [abs(a - b) for a, b in zip(losses, l64)]
        par_d = {k: float((v.cpu().double() - ref_p[k]).abs().max())
                 for k, v in _named(net.params).items()}
        return loss_d, par_d

    cpu_loss_d, cpu_par_d = distances(cpu, l32)
    loss_limit = [max(CHAR_CHECK_MULT * d, CHAR_CHECK_FRAC * abs(v))
                  for d, v in zip(cpu_loss_d, l64)]
    par_limit = {k: max(CHAR_CHECK_MULT * d, CHAR_CHECK_FRAC * float(ref_p[k].abs().max()))
                 for k, d in cpu_par_d.items()}

    def over(net, losses):
        """The largest distance over its limit, losses and parameters."""
        loss_d, par_d = distances(net, losses)
        return max([d / lim for d, lim in zip(loss_d, loss_limit)]
                   + [par_d[k] / par_limit[k] for k in par_d])

    card_over = over(card, lg)
    label = "graph_char_rnn_card_vs_cpu" if graph else "char_rnn_card_vs_cpu"
    if not card_over <= 1.0:
        raise AssertionError(f"{label}: {card_over} times its limit "
                             f"(losses card {lg}, cpu {l32}, float64 {l64})")
    no_peep = tree_map(lambda v: v, start)
    for p in (no_peep.values() if graph else no_peep):
        for k in ("p_i", "p_f", "p_o"):
            if k in p:
                p[k] = torch.zeros_like(p[k])
    peep_over = over(*fit(dev, params=no_peep))
    dropped = build(dev)
    drop_losses = [float(v) for s in range(0, steps, CHAR_T)
                   for v in _fit_windows(torch, dropped, x[:, s:s + CHAR_T],
                                         y[:, s:s + CHAR_T],
                                         mask=None if mask is None else mask[:, s:s + CHAR_T])]
    drop_over = over(dropped, drop_losses)
    if not (peep_over > 1.0 and drop_over > 1.0):
        raise AssertionError(f"{label}: a control meets the limits (zeroed "
                             f"peepholes {peep_over}, carries dropped {drop_over})")
    summary = {"windows": CHAR_CHECK_WINDOWS, "batch": CHAR_BATCH, "losses_card": lg,
               "losses_cpu": l32, "losses_f64": l64, "loss_limit": loss_limit,
               "card_over_limit": card_over,
               "worst_params": sorted(((distances(card, lg)[1][k] / par_limit[k], k)
                                       for k in par_limit), reverse=True)[:4],
               "zeroed_peepholes_control_over_limit": peep_over,
               "dropped_carries_control_over_limit": drop_over,
               "seconds": time.perf_counter() - t0}
    if graph:
        summary["masked_chars"] = int(mask.sum())
    print(f"{label} " + json.dumps(summary), flush=True)
    return summary


def _flash_bwd_kernel_entry(name, rows, train):
    """The kernels-line entry of flash_attn_bwd_dkv or flash_attn_bwd_dq:
    numbers at the training path's shape and layout, (8, 12, 1024, 64)
    causal float32 head-split views; launches on both training runs; the
    other shapes beside."""
    key = ("b", "h", "t", "d", "causal", "dtype", "layout")
    main = next(r for r in rows if tuple(r[k] for k in key) == FLASH_BWD_CASES[0])
    line = {"dkv": 941, "dq": 1287}[name.rsplit("_", 1)[1]]
    # both were redesigned: each first design is timed beside it
    timed = ("ms", "host_ms", "previous_ms")
    return {"name": name, "route": "cuda",
            "source": f"deeplearning4j_tpu_torch/csrc/{name}.cu",
            "replaces": "deeplearning4j_tpu/parallel/ring_attention.py:108",
            "tpu_kernel": f"jax/experimental/pallas/ops/tpu/flash_attention.py:{line}",
            **_launches_by_path(name, train),
            "max_abs_err": main[name]["max_abs_err"],
            "max_err_over_limit_all_cases": max(r[name]["max_err_over_limit"] for r in rows),
            **{f: main[name][f] for f in timed},
            "plain_ms": main[name]["plain_ms"],
            "bound_ms": main[name]["bound_ms"], "bound_by": main[name]["bound_by"],
            "library_ms": main["library_ms"],
            "library": "autograd backward of F.scaled_dot_product_attention (dq, dk, dv)",
            "shape": {k: main[k] for k in key},
            "other_shapes": [dict({k: r[k] for k in key + ("library_ms",)},
                                  **{f: r[name][f] for f in timed + ("plain_ms", "bound_ms")})
                             for r in rows if r is not main]}


def sass_counts(build, names, mark):
    """How many SASS instructions of ``mark`` each named library holds
    (cuobjdump -sass); raises if one of them holds none."""
    import os
    tool = os.path.join(os.path.dirname(build.nvcc()), "cuobjdump")
    counts = {}
    for name in names:
        out = subprocess.run([tool, "-sass", str(build.library_path(name))],
                             capture_output=True, text=True, check=True, timeout=300).stdout
        counts[name] = out.count(mark)
    print(f"sass {mark}: " + json.dumps(counts), flush=True)
    if not all(counts.values()):
        raise AssertionError(f"a tensor-core kernel holds no {mark}: {counts}")
    return counts


# ------------------------------------------------- slice 13: the zoo paths
# TinyYOLO's detection configuration as the tiny-yolo-voc.cfg of Darknet and
# DL4J's zoo/model/TinyYOLO.java publish it: the five VOC anchor priors in
# grid units, 20 classes, 416 x 416 x 3 (a 13 x 13 grid)
VOC_PRIORS = [(1.08, 1.19), (3.42, 4.41), (6.63, 11.38), (9.42, 5.11), (16.62, 10.52)]
YOLO_BATCH, YOLO_SIDE, YOLO_CLASSES, YOLO_STEPS = 64, 416, 20, 20
YOLO_FUSED_BLOCKS = 7
FACENET_BATCH, FACENET_STEPS, FACENET_FUSED_BLOCKS = 64, 10, 37
# TinyYOLO's seven bn shapes at batch 64 (rows = 64 * h * w), bf16 leaky
# ReLU, the stem in float32 too; the layer_families phase's fused separable
# head (64 x 56 x 56 -> 128) and 1-D head (64 x 1024 -> 256)
YOLO_BN_CASES = [
    ("yolo1", 11075584, 16, "bfloat16", "leakyrelu", False),
    ("yolo1", 11075584, 16, "float32", "leakyrelu", False),
    ("yolo2", 2768896, 32, "bfloat16", "leakyrelu", False),
    ("yolo3", 692224, 64, "bfloat16", "leakyrelu", False),
    ("yolo4", 173056, 128, "bfloat16", "leakyrelu", False),
    ("yolo5", 43264, 256, "bfloat16", "leakyrelu", False),
    ("yolo6", 10816, 512, "bfloat16", "leakyrelu", False),
    ("yolo7", 10816, 1024, "bfloat16", "leakyrelu", False),
    ("separable", 200704, 128, "bfloat16", "relu", False),
    ("conv1d", 65536, 256, "bfloat16", "relu", False),
]
SEP_SHAPE, SEP_OUT = (64, 56, 56, 64), 128
C1D_SHAPE, C1D_OUT = (64, 1024, 64), 256
# zoo phase: the new zoo models at their published input shapes
ZOO_MODELS = ["AlexNet", "Darknet19", "GoogLeNet", "InceptionResNetV1", "FaceNetNN4Small2",
              "SimpleCNN", "TinyYOLO"]
# card against CPU, float32 both: softmax outputs within 1e-4 absolute (the
# same weights through 20-60 layers of cuDNN and CPU convolutions summing in
# other orders); a folded network within tests/test_fusion.py's rtol 2e-4 /
# atol 2e-5 of the unfolded one
ZOO_OUT_ATOL = 1e-4
FOLD_RTOL, FOLD_ATOL = 2e-4, 2e-5


def yolo_batch(torch, dev, n, side, classes, seed=0):
    """Synthetic detection data in tests/test_layer_families.py's fixture
    form: images U[0, 1), 1-3 boxes an image, each in a random cell of the
    side / 32 grid, 0.5-2 grid units wide and high, with a random class;
    labels (n, grid, grid, 4 + classes), corners in grid units."""
    grid = side // 32
    rng = np.random.default_rng(seed)
    x = rng.random((n, side, side, 3), dtype=np.float32)
    lab = np.zeros((n, grid, grid, 4 + classes), np.float32)
    for e in range(n):
        for _ in range(int(rng.integers(1, 4))):
            cy, cx = rng.integers(0, grid), rng.integers(0, grid)
            w, h = rng.uniform(0.5, 2.0, 2)
            x1, y1 = cx + 0.5 - w / 2, cy + 0.5 - h / 2
            lab[e, cy, cx, :] = 0.0
            lab[e, cy, cx, :4] = [x1, y1, x1 + w, y1 + h]
            lab[e, cy, cx, 4 + int(rng.integers(0, classes))] = 1.0
    return torch.from_numpy(x).to(dev), torch.from_numpy(lab).to(dev)


def yolo_conf(side, dtype="bfloat16", renormalize=True, updater=None):
    """TinyYOLO's detection configuration over the VOC priors, fused. With
    ``renormalize`` every layer takes DL4J's TinyYOLO.java gradient
    normalization (RenormalizeL2PerLayer, threshold 1). The JAX package's
    configuration leaves it out; with the model's Nesterovs(1e-3, 0.9) it
    then turns NaN on these batches (tools/yolo_divergence.py shows
    where)."""
    import dataclasses

    from deeplearning4j_tpu_torch.models import TinyYOLO
    conf = TinyYOLO(num_classes=YOLO_CLASSES, input_shape=(side, side, 3),
                    updater=updater).detection_conf(VOC_PRIORS)
    if renormalize:
        conf = dataclasses.replace(conf, layers=tuple(
            dataclasses.replace(layer, gradient_normalization="renormalizel2perlayer",
                                gradient_normalization_threshold=1.0)
            if hasattr(layer, "gradient_normalization") else layer for layer in conf.layers))
    return dataclasses.replace(conf.fused(), dtype=dtype)


def _fused_blocks(conf):
    from deeplearning4j_tpu_torch.nn.conf.convolutional import FusedConvBNActivation
    objs = (conf.layers if hasattr(conf, "layers") else [o for o, _ in conf.vertices.values()])
    return sum(isinstance(o, FusedConvBNActivation) for o in objs)


def yolo_training_phase(torch, dev, card) -> dict:
    """TinyYOLO's detection network (416 x 416 x 3, 20 classes, the five VOC
    priors) after conf.fused() (7 fused leaky-ReLU blocks of 16-1024
    channels), bf16 compute with float32 masters, its own Nesterovs(1e-3,
    0.9) with DL4J TinyYOLO.java's RenormalizeL2PerLayer gradient
    normalization, trained YOLO_STEPS steps through MultiLayerNetwork.fit
    on one fixed batch of 64: every loss finite, the last below the first,
    bn_act_fwd and bn_act_bwd launched 7 times a step each and no other
    kernel; step ms (median of the steps after the first two), images/s,
    one step profiled by kernel family."""
    from deeplearning4j_tpu_torch.datasets import DataSet
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu_torch.perf.kernels import bn_act

    x, y = yolo_batch(torch, dev, YOLO_BATCH, YOLO_SIDE, YOLO_CLASSES)
    ds = DataSet(x, y)
    conf = yolo_conf(YOLO_SIDE)
    if _fused_blocks(conf) != YOLO_FUSED_BLOCKS:
        raise AssertionError(f"{_fused_blocks(conf)} fused blocks, want {YOLO_FUSED_BLOCKS}")
    net = MultiLayerNetwork(conf, dev).init()
    torch.cuda.reset_peak_memory_stats()
    _zero_launch_counts()
    losses, times = _timed_steps(torch, net, ds, 0, YOLO_STEPS)
    fwd, bwd = bn_act.fwd_launches, bn_act.bwd_launches
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"yolo_training: losses {losses}")
    if not fwd == bwd == YOLO_FUSED_BLOCKS * YOLO_STEPS:
        raise AssertionError(f"bn_act launched {fwd} forward / {bwd} backward in "
                             f"{YOLO_STEPS} steps; want {YOLO_FUSED_BLOCKS * YOLO_STEPS} each")
    others = {k: v for k, v in _launch_counts().items() if v and not k.startswith("bn_act")}
    if others:
        raise AssertionError(f"yolo_training launched other kernels: {others}")
    step_ms = float(np.median(times[2:]))
    profile = _profile_step(torch, net, ds, step_ms)
    summary = {"card": card, "batch": YOLO_BATCH, "side": YOLO_SIDE, "dtype": "bfloat16",
               "steps": YOLO_STEPS, "losses": losses, "first_loss": losses[0],
               "last_loss": losses[-1], "last_over_first": losses[-1] / losses[0],
               "median_step_ms": step_ms, "images_per_s": YOLO_BATCH / (step_ms / 1e3),
               "bn_act_fwd_launches": fwd, "bn_act_bwd_launches": bwd,
               "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
               "params": net.num_params()}
    print("yolo_training " + json.dumps(summary), flush=True)
    print("yolo_training_profile " + json.dumps(profile), flush=True)
    del net, ds
    torch.cuda.empty_cache()
    return {"fwd": fwd, "bwd": bwd}


def _copy_to(tree, device, dtype):
    """A copy of a network's parameter or state tree on ``device`` in
    ``dtype``."""
    from deeplearning4j_tpu_torch.nn.tree import tree_map
    return tree_map(lambda v: v.to(device, dtype, copy=True), tree)


def yolo_card_vs_cpu_phase(torch, dev) -> dict:
    """TinyYOLO's detection configuration at 64 x 64 (a 2 x 2 grid), float32,
    batch 2: one Sgd(0.1) step on the card through the kernels and, with
    copied weights, on the CPU through the plain versions, and in float64 on
    the CPU as the referee. Loss within rtol 1e-4; the gradients of the
    first block's W, the fourth's gamma and the head's W within 3x the CPU
    float32 step's distance to float64 or 1e-3 of the tensor's max-abs;
    the updated running stats of every block within rtol 1e-4 / atol 1e-6
    of the CPU's; get_predicted_objects on both networks' outputs before the
    step (threshold 0.5) the same boxes and classes, apart from confidences
    within 1e-4 of the threshold and classes whose top two probabilities
    are within 1e-4. Control: the same card step with the blocks' activation
    ReLU in place of leaky ReLU must miss the gradient limit."""
    import dataclasses

    from deeplearning4j_tpu_torch.nn.conf.convolutional import FusedConvBNActivation
    from deeplearning4j_tpu_torch.nn.conf.objdetect import get_predicted_objects
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu_torch.optimize.updaters import Sgd
    from deeplearning4j_tpu_torch.perf.kernels import bn_act

    side = 64
    conf = yolo_conf(side, dtype="float32", renormalize=False, updater=Sgd(learning_rate=0.1))
    card = MultiLayerNetwork(conf, dev).init()
    f32, f64 = torch.float32, torch.float64
    cpu = MultiLayerNetwork(conf, "cpu").set_params(_copy_to(card.params, "cpu", f32),
                                                     _copy_to(card.state, "cpu", f32))
    cpu64 = MultiLayerNetwork(dataclasses.replace(conf, dtype="float64"), "cpu").set_params(
        _copy_to(card.params, "cpu", f64), _copy_to(card.state, "cpu", f64))
    relu_conf = dataclasses.replace(conf, layers=tuple(
        dataclasses.replace(l, activation="relu") if isinstance(l, FusedConvBNActivation) else l
        for l in conf.layers))
    control = MultiLayerNetwork(relu_conf, dev).set_params(_copy_to(card.params, dev, f32),
                                                            _copy_to(card.state, dev, f32))
    x, y = yolo_batch(torch, "cpu", 2, side, YOLO_CLASSES, seed=1)
    blocks = [i for i, l in enumerate(conf.layers) if isinstance(l, FusedConvBNActivation)]
    head = len(conf.layers) - 2
    out_card, out_cpu = card.output(x.to(dev)).cpu(), cpu.output(x)  # the initial weights
    results = {}
    for name, net in (("card", card), ("cpu", cpu), ("cpu64", cpu64), ("control", control)):
        f0 = bn_act.fwd_launches
        xx, yy = x.to(net.device), y.to(net.device)
        loss, grads, state = net._loss_and_grads(xx, yy, None, None, None)
        net._apply_updates(grads)
        net._commit_state(state)
        if net.device.type == "cuda" and bn_act.fwd_launches - f0 != YOLO_FUSED_BLOCKS:
            raise AssertionError(f"{name}: the step did not run every block's kernel")
        results[name] = (float(loss), grads)
    (lg, gg), (lc, gc), (_, g64), (_, gctl) = (results[k] for k in ("card", "cpu", "cpu64",
                                                                     "control"))
    if abs(lg - lc) > 1e-4 * abs(lc):
        raise AssertionError(f"card loss {lg} vs CPU loss {lc}")
    report, control_missed = {}, []
    for i, k in ((blocks[0], "W"), (blocks[3], "gamma"), (head, "W")):
        ref = g64[i][k]
        scale = float(ref.abs().max())
        cpu_err = float((gc[i][k].double() - ref).abs().max())
        limit = max(3.0 * cpu_err, 1e-3 * scale)
        card_err = float((gg[i][k].cpu().double() - ref).abs().max())
        ctl_err = float((gctl[i][k].cpu().double() - ref).abs().max())
        if card_err > limit:
            raise AssertionError(f"gradient {i}/{k}: card vs float64 {card_err} > {limit}")
        control_missed.append(ctl_err > limit)
        report[f"{i}/{k}"] = {"card_vs_f64": card_err / scale, "cpu_vs_f64": cpu_err / scale,
                              "control_vs_f64": ctl_err / scale, "limit": limit / scale}
    if not any(control_missed):
        raise AssertionError(f"the ReLU control met every gradient limit: {report}")
    stats_err = 0.0
    for i in blocks:
        for k in ("mean", "var"):
            got, want = card.state[i][k].cpu(), cpu.state[i][k]
            err = (got - want).abs()
            if not bool((err <= 1e-6 + 1e-4 * want.abs()).all()):
                raise AssertionError(f"running {k} of layer {i}: max |diff| {float(err.max())}")
            stats_err = max(stats_err, float(err.max()))
    th, n_boxes = 0.5, len(VOC_PRIORS)
    a5c, a5p = (o.reshape(o.shape[:3] + (n_boxes, -1)) for o in (out_card, out_cpu))
    near = ((a5c[..., 4] - th).abs() <= 1e-4) | ((a5p[..., 4] - th).abs() <= 1e-4)
    flipped = (a5c[..., 4] >= th) != (a5p[..., 4] >= th)
    if bool((flipped & ~near).any()):
        raise AssertionError("detections differ between the card and the CPU")
    top2 = a5p[..., 5:].topk(2, dim=-1).values
    tie = (top2[..., 0] - top2[..., 1]) <= 1e-4
    both = (a5c[..., 4] >= th) & (a5p[..., 4] >= th) & ~tie
    if not torch.equal(a5c[..., 5:].argmax(-1)[both], a5p[..., 5:].argmax(-1)[both]):
        raise AssertionError("detected classes differ between the card and the CPU")
    dc, dp = (get_predicted_objects(o, n_boxes, th) for o in (out_card, out_cpu))
    if not bool(near.any()) and len(dc) != len(dp):
        raise AssertionError(f"{len(dc)} detections on the card, {len(dp)} on the CPU")
    summary = {"side": side, "batch": 2, "card_loss": lg, "cpu_loss": lc,
               "loss_rel_diff": abs(lg - lc) / abs(lc), "grad_err_over_max_abs": report,
               "running_stats_max_abs_diff": stats_err, "detections": [len(dc), len(dp)],
               "output_max_abs_diff": float((out_card - out_cpu).abs().max())}
    print("yolo_card_vs_cpu " + json.dumps(summary), flush=True)
    del card, control
    torch.cuda.empty_cache()
    return summary


def facenet_training_phase(torch, dev, card) -> dict:
    """FaceNetNN4Small2 with its own defaults (96 x 96 x 3, 128-d embedding,
    CenterLoss alpha 0.9 and lambda 1e-4, Adam(1e-3), 1,000 classes) after
    conf.fused() (37 fused blocks, no BatchNormalization left), bf16 with
    float32 masters, through ComputationGraph.fit on one fixed batch of 64
    (images U[0, 1), classes from numpy.random.default_rng(0)) for
    FACENET_STEPS steps: losses finite and falling, the centers cL off
    zero, 37 + 37 bn launches a step; step ms, images/s."""
    import dataclasses

    from deeplearning4j_tpu_torch.datasets import DataSet
    from deeplearning4j_tpu_torch.models import FaceNetNN4Small2
    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
    from deeplearning4j_tpu_torch.perf.kernels import bn_act

    model = FaceNetNN4Small2()
    conf = dataclasses.replace(model.conf().fused(), dtype="bfloat16")
    if _fused_blocks(conf) != FACENET_FUSED_BLOCKS or any(
            type(o).__name__ == "BatchNormalization" for o, _ in conf.vertices.values()):
        raise AssertionError(f"{_fused_blocks(conf)} fused blocks; want "
                             f"{FACENET_FUSED_BLOCKS} and no BatchNormalization")
    net = ComputationGraph(conf, dev).init()
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.random((FACENET_BATCH,) + model.input_shape, dtype=np.float32))
    y = torch.from_numpy(np.eye(model.num_classes, dtype=np.float32)[
        rng.integers(0, model.num_classes, FACENET_BATCH)])
    ds = DataSet(x.to(dev), y.to(dev))
    _zero_launch_counts()
    losses, times = _timed_steps(torch, net, ds, 0, FACENET_STEPS)
    fwd, bwd = bn_act.fwd_launches, bn_act.bwd_launches
    centers = float(net.params["lossLayer"]["cL"].abs().max())
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"facenet_training: losses {losses}")
    if not centers > 0:
        raise AssertionError("facenet_training: the centers did not move")
    if not fwd == bwd == FACENET_FUSED_BLOCKS * FACENET_STEPS:
        raise AssertionError(f"bn_act launched {fwd} / {bwd} in {FACENET_STEPS} steps")
    step_ms = float(np.median(times[2:]))
    summary = {"card": card, "batch": FACENET_BATCH, "side": model.input_shape[0],
               "dtype": "bfloat16", "steps": FACENET_STEPS, "losses": losses,
               "median_step_ms": step_ms, "images_per_s": FACENET_BATCH / (step_ms / 1e3),
               "centers_max_abs": centers, "bn_act_fwd_launches": fwd,
               "bn_act_bwd_launches": bwd, "params": net.num_params()}
    print("facenet_training " + json.dumps(summary), flush=True)
    del net, ds
    torch.cuda.empty_cache()
    return {"fwd": fwd, "bwd": bwd}


def yolo_bn_kernel_phase(torch, dev, flush):
    rows = [bn_case(torch, dev, flush, *case) for case in YOLO_BN_CASES]
    torch.cuda.empty_cache()
    return rows


def _randomize_bn_stats(torch, net, seed=0):
    gen = torch.Generator(device="cpu").manual_seed(seed)
    items = net.state.items() if isinstance(net.state, dict) else enumerate(net.state)
    for _, s in items:
        if "mean" in s:
            s["mean"].copy_(0.1 * torch.randn(s["mean"].shape, generator=gen))
            s["var"].copy_(0.5 + torch.rand(s["var"].shape, generator=gen))


def _output(torch, net, x):
    """A network's inference output as a CPU tensor."""
    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
    out = net.output_single(x) if isinstance(net, ComputationGraph) else net.output(x)
    return out.cpu() if isinstance(out, torch.Tensor) else torch.from_numpy(np.asarray(out))


def zoo_phase(torch, dev) -> dict:
    """Each new zoo model (TinyYOLO as its backbone with the classification
    head) at its published input shape: parameter count; a float32 forward
    at batch 2 on the card against the port on the CPU with the same
    weights and randomised running stats (within ZOO_OUT_ATOL); fold_bn's
    network against the unfolded one on the card where it folds (rtol 2e-4
    / atol 2e-5); one bf16 fit step of the fused network (finite loss),
    with its bn launches."""
    import dataclasses

    import deeplearning4j_tpu_torch.models as zoo
    from deeplearning4j_tpu_torch.datasets import DataSet
    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu_torch.perf.fusion import fold_bn
    from deeplearning4j_tpu_torch.perf.kernels import bn_act

    rows, launches = [], {"fwd": 0, "bwd": 0}
    for name in ZOO_MODELS:
        t0 = time.perf_counter()
        model = getattr(zoo, name)()
        conf = model.conf()
        cls = ComputationGraph if hasattr(conf, "vertices") else MultiLayerNetwork
        cpu = cls(conf, "cpu").init()
        _randomize_bn_stats(torch, cpu)
        card = cls(conf, dev).set_params(_copy_to(cpu.params, dev, torch.float32),
                                        _copy_to(cpu.state, dev, torch.float32))
        x = np.random.default_rng(1).random((2,) + tuple(model.input_shape), dtype=np.float32)
        xd = torch.from_numpy(x).to(dev)
        want, got = _output(torch, cpu, x), _output(torch, card, xd)
        err = float((got - want).abs().max())
        if err > ZOO_OUT_ATOL:
            raise AssertionError(f"zoo {name}: card vs CPU output {err} > {ZOO_OUT_ATOL}")
        diff = (_output(torch, fold_bn(card), xd) - got).abs()
        fold_err = float(diff.max())
        if not bool((diff <= FOLD_ATOL + FOLD_RTOL * got.abs()).all()):
            raise AssertionError(f"zoo {name}: folded vs unfolded {fold_err}")
        n_params = cpu.num_params()
        del cpu, card
        fused = dataclasses.replace(conf.fused(), dtype="bfloat16")
        net = cls(fused, dev).init()
        yy = np.eye(model.num_classes, dtype=np.float32)[[0, 1]]
        f0, b0 = bn_act.fwd_launches, bn_act.bwd_launches
        net.fit(DataSet(torch.from_numpy(x).to(dev), torch.from_numpy(yy).to(dev)))
        torch.cuda.synchronize()
        step = {"fwd": bn_act.fwd_launches - f0, "bwd": bn_act.bwd_launches - b0}
        if step["fwd"] != _fused_blocks(fused) or step["bwd"] != _fused_blocks(fused):
            raise AssertionError(f"zoo {name}: bn launches {step}, "
                                 f"{_fused_blocks(fused)} fused blocks")
        for k in launches:
            launches[k] += step[k]
        if not np.isfinite(net.score()):
            raise AssertionError(f"zoo {name}: bf16 step loss {net.score()}")
        row = {"model": name, "input_shape": list(model.input_shape), "params": n_params,
               "out_max_abs_diff_card_cpu": err, "fold_max_abs_diff": fold_err,
               "fused_blocks": _fused_blocks(fused), "bf16_step_loss": net.score(),
               "seconds": time.perf_counter() - t0}
        print("zoo " + json.dumps(row), flush=True)
        rows.append(row)
        del net
        torch.cuda.empty_cache()
    return launches


def _family_nets():
    """The layer_families phase's networks as (name, conf, x, y): the fused
    separable and 1-D chains at SEP_SHAPE / C1D_SHAPE, a VAE pretrained, and
    one CenterLossOutputLayer, LocalResponseNormalization, Upsampling and
    Cropping network each."""
    from deeplearning4j_tpu_torch.nn.conf import convolutional as cv
    from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
    from deeplearning4j_tpu_torch.nn.conf.layers import (ActivationLayer, CenterLossOutputLayer,
                                                         DenseLayer, OutputLayer)
    from deeplearning4j_tpu_torch.nn.conf.network import NeuralNetConfiguration
    from deeplearning4j_tpu_torch.nn.conf.normalization import (BatchNormalization,
                                                                LocalResponseNormalization)
    from deeplearning4j_tpu_torch.nn.conf.pooling import GlobalPoolingLayer
    from deeplearning4j_tpu_torch.nn.conf.recurrent import RnnOutputLayer
    from deeplearning4j_tpu_torch.nn.conf.variational import VariationalAutoencoder
    from deeplearning4j_tpu_torch.optimize.updaters import Sgd

    def conf(layers, it):
        b = NeuralNetConfiguration.builder().seed(5).updater(Sgd(learning_rate=0.1)).list()
        for layer in layers:
            b = b.layer(layer)
        return b.set_input_type(it).build()

    rng = np.random.default_rng(3)

    def onehot(n, k, shape=None):
        return np.eye(k, dtype=np.float32)[rng.integers(0, k, shape or n)]

    nb, h, w, c = SEP_SHAPE
    nt, t, ct = C1D_SHAPE
    return [
        ("fused_separable", conf([cv.SeparableConvolution2D(n_out=SEP_OUT, has_bias=False,
                                                            convolution_mode="same"),
                                  BatchNormalization(), ActivationLayer(activation="relu"),
                                  GlobalPoolingLayer(pooling_type="avg"),
                                  OutputLayer(n_out=10)], InputType.convolutional(h, w, c)).fused(),
         rng.random(SEP_SHAPE, dtype=np.float32), onehot(nb, 10)),
        ("fused_conv1d", conf([cv.Convolution1DLayer(n_out=C1D_OUT, has_bias=False,
                                                     convolution_mode="same"),
                               BatchNormalization(), ActivationLayer(activation="relu"),
                               RnnOutputLayer(n_out=5)], InputType.recurrent(ct, t)).fused(),
         rng.standard_normal(C1D_SHAPE).astype(np.float32), onehot(nt, 5, (nt, t))),
        ("vae_pretrain", conf([VariationalAutoencoder(n_out=16, encoder_layer_sizes=(256,),
                                                      decoder_layer_sizes=(256,)),
                               OutputLayer(n_out=10)], InputType.feed_forward(784)),
         rng.random((64, 784), dtype=np.float32), onehot(64, 10)),
        ("center_loss", conf([DenseLayer(n_out=128, activation="relu"),
                              CenterLossOutputLayer(n_out=100, alpha=0.9, lamda=1e-4)],
                             InputType.feed_forward(256)),
         rng.standard_normal((64, 256)).astype(np.float32), onehot(64, 100)),
        ("lrn", conf([cv.ConvolutionLayer(n_out=96, kernel_size=(5, 5), activation="relu"),
                      LocalResponseNormalization(), GlobalPoolingLayer(pooling_type="avg"),
                      OutputLayer(n_out=10)], InputType.convolutional(64, 64, 3)),
         rng.random((16, 64, 64, 3), dtype=np.float32), onehot(16, 10)),
        ("upsampling_cropping", conf([cv.ConvolutionLayer(n_out=32, kernel_size=(3, 3),
                                                          activation="relu"),
                                      cv.Upsampling2D(size=(2, 2)),
                                      cv.Cropping2D(cropping=(1, 2, 2, 1)),
                                      cv.ZeroPaddingLayer(padding=(1, 1)),
                                      GlobalPoolingLayer(pooling_type="max"),
                                      OutputLayer(n_out=10)], InputType.convolutional(32, 32, 3)),
         rng.random((16, 32, 32, 3), dtype=np.float32), onehot(16, 10)),
    ]


def layer_families_phase(torch, dev) -> dict:
    """Each _family_nets network takes one Sgd(0.1) step in float32 on the
    card and, with copied weights, on the CPU (the VAE one pretrain_layer
    step, its draws taken on the CPU and fed to both): loss within rtol
    1e-4 and every updated parameter within 1e-5 + 1e-4 of its max-abs of
    the CPU's; bn launches counted where the chain fused (one each)."""
    from deeplearning4j_tpu_torch.datasets import DataSet
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu_torch.nn.tree import tree_leaves
    from deeplearning4j_tpu_torch.perf.kernels import bn_act

    launches = {"fwd": 0, "bwd": 0}
    for name, conf, x, y in _family_nets():
        cpu = MultiLayerNetwork(conf, "cpu").init()
        card = MultiLayerNetwork(conf, dev).set_params(_copy_to(cpu.params, dev, torch.float32),
                                                        _copy_to(cpu.state, dev, torch.float32))
        card_ds = DataSet(torch.from_numpy(x).to(dev), torch.from_numpy(y).to(dev))
        if name == "vae_pretrain":
            draws = cpu.layers[0].draw_pretrain(torch.from_numpy(x),
                                                torch.Generator().manual_seed(7))
            cpu.pretrain_layer(0, [DataSet(x, y)], draws=[draws])
            f0, b0 = bn_act.fwd_launches, bn_act.bwd_launches
            card.pretrain_layer(0, [card_ds], draws=[[d.to(dev) for d in draws]])
        else:
            cpu.fit(DataSet(x, y))
            f0, b0 = bn_act.fwd_launches, bn_act.bwd_launches
            card.fit(card_ds)
        torch.cuda.synchronize()
        step = {"fwd": bn_act.fwd_launches - f0, "bwd": bn_act.bwd_launches - b0}
        want_bn = 1 if name.startswith("fused") else 0
        if step["fwd"] != want_bn or step["bwd"] != want_bn:
            raise AssertionError(f"layer_families {name}: bn launches {step}")
        for k in launches:
            launches[k] += step[k]
        lc, lg = cpu.score(), card.score()
        if abs(lg - lc) > 1e-4 * abs(lc):
            raise AssertionError(f"layer_families {name}: card loss {lg} vs CPU {lc}")
        worst = 0.0
        for pc, pg in zip(tree_leaves(cpu.params), tree_leaves(card.params)):
            err = float((pg.cpu() - pc).abs().max())
            if err > 1e-5 + 1e-4 * float(pc.abs().max()):
                raise AssertionError(f"layer_families {name}: updated parameter off by {err}")
            worst = max(worst, err / max(float(pc.abs().max()), 1e-12))
        row = {"net": name, "card_loss": lg, "cpu_loss": lc, "loss_rel_diff": abs(lg - lc) / abs(lc),
               "param_err_over_max_abs": worst, "bn_launches": step}
        print("layer_families " + json.dumps(row), flush=True)
        del card
        torch.cuda.empty_cache()
    return launches


# ------------------------------------------------------------ the serving tier
VGG_SIDE = 224            # VGG16's published input side
MS_CLIENTS = 4            # client threads of the model_server, hot_swap and ivf loads
MS_PREDICTS = 8           # predict requests a client (rows 1-4)
MS_QUERIES = 24           # :query requests a client (rows 1-8, k of 1, 10 or 32)
MS_BATCH_LIMIT = 16       # the VGG16 endpoint's coalesced requests a dispatch
MS_DEADLINE_MS = 60_000   # every request of a load must answer 200; 504 is checked apart
PREDICT_LIMIT = 1e-5      # of the row's largest magnitude
TOP1_GAP = 1e-4
SWAP_PERTURB = 0.1        # step 2: every weight times (1 + 0.1 N(0, 1)), seeded
SWAP_LOAD_S = 1.5         # load before and after the swap
# decode: bench.py bench_decode's non-QUICK load on BASELINE configs[2]'s
# TextGenerationLSTM (two GravesLSTM(256), 47 characters)
DECODE_SESSIONS, DECODE_TOKENS, DECODE_PROMPT = 32, 128, 12
DECODE_BUCKETS = (16, 64)
DECODE_TIE = 1e-4         # sequential top-2 log-probability gap of a near-tie
DECODE_SWAP_SESSIONS, DECODE_SWAP_TOKENS = 8, 1024  # long enough to outlive the swap
# IVF: bench.py bench_retrieval's IVFIndex(V) and IVFIndex(V, int8=True) on
# the 1,000,000 x 64 corpus of 7 (1000 cells, nprobe 8); recall@10 of the
# JAX package's own indexes, measured on the card host's CPU by
# PYTHONPATH=. JAX_PLATFORMS=cpu python tests/test_torch_ivf.py, and the gates
# 0.01 under
JAX_IVF_RECALL = {"fp32": 0.9998046875, "int8": 0.97314453125}
IVF_RECALL_GATES = {codec: r - 0.01 for codec, r in JAX_IVF_RECALL.items()}
IVF_VARIANTS = [("ivf", {}), ("ivf_csr", {"layout": "csr"}),
                ("ivf_int8", {"int8": True}), ("ivf_int8_csr", {"int8": True, "layout": "csr"})]


class GatedModel:
    """A served model whose dispatches can be held at a gate: the lever of
    the card's 429 and 504 checks. Everything else delegates."""

    def __init__(self, inner):
        self._inner = inner
        self.gate = threading.Event()
        self.gate.set()
        self.entered = threading.Event()

    def output(self, x):
        self.entered.set()
        if not self.gate.wait(120):
            raise AssertionError("gate held past 120 s")
        return self._inner.output(x)

    def __getattr__(self, name):
        return getattr(self.__dict__["_inner"], name)


def _http(base, method, path, body=None, timeout=600):
    """(status, parsed body, headers, request bytes) of one request."""
    import urllib.error
    import urllib.request

    data = None if body is None else (body if isinstance(body, bytes)
                                      else json.dumps(body).encode())
    req = urllib.request.Request(base + path, data=data, method=method)
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            raw, code, hdrs = r.read(), r.status, dict(r.headers)
    except urllib.error.HTTPError as e:
        raw, code, hdrs = e.read(), e.code, dict(e.headers)
    try:
        parsed = json.loads(raw)
    except ValueError:
        parsed = raw.decode(errors="replace")
    return code, parsed, hdrs, len(data or b"")


def _header_only_post(port, path, length):
    """A POST announcing ``length`` body bytes and sending none: the server
    must answer from the header alone."""
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    try:
        conn.putrequest("POST", path)
        conn.putheader("Content-Length", str(length))
        conn.endheaders()
        r = conn.getresponse()
        return r.status, json.loads(r.read())
    finally:
        conn.close()


def _wait_for(pred, what, timeout=120.0):
    end = time.monotonic() + timeout
    while not pred():
        if time.monotonic() > end:
            raise AssertionError(f"timed out waiting for {what}")
        time.sleep(0.002)


def _run_clients(jobs_of, clients):
    """Run each client's job list on its own thread; a job is (label, path,
    body, meta). Returns [(cid, label, meta, status, body, ms, bytes)]."""
    out, errors = [], []

    def client(cid):
        try:
            for label, path, body, meta in jobs_of(cid):
                t0 = time.perf_counter()
                code, parsed, _, nbytes = _http(BASE[0], "POST", path, body)
                out.append((cid, label, meta, code, parsed,
                            (time.perf_counter() - t0) * 1e3, nbytes))
        except Exception as e:  # re-raised on the main thread
            errors.append(e)

    threads = [threading.Thread(target=client, args=(c,)) for c in range(clients)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=900)
    wall = time.perf_counter() - t0
    if errors:
        raise errors[0]
    if any(t.is_alive() for t in threads):
        raise AssertionError("a client thread did not finish")
    return out, wall


BASE = [None]  # the address _run_clients posts to


def _query_jobs(names, Q, seed):
    from deeplearning4j_tpu_torch.serving.wire import encode_array

    crng = np.random.default_rng(seed)
    jobs = []
    for i in range(MS_QUERIES):
        name = names[i % len(names)]
        rows = int(crng.integers(1, 9))
        sel = crng.integers(0, len(Q), rows)
        k = int(crng.choice([1, 10, 32], p=[0.15, 0.7, 0.15]))
        body = dict(encode_array(Q[sel]), k=k, b64=True)
        jobs.append((name, f"/v1/indexes/{name}:query", body, (sel, k)))
    return jobs


def _decode_b64(body, field, dtype):
    import base64
    return np.frombuffer(base64.b64decode(body[field]), dtype=dtype).reshape(body["shape"])


def _hold_queries(results, indexes, Q, rtol=None):
    """Every 200 of a :query against the index's own search of those rows,
    at the k its coalesced batch dispatched with (k' >= k of the mix):
    bitwise, or with ``rtol`` distances within rtol and ids equal apart
    from near-ties (7's rule)."""
    checked = 0
    for _, name, meta, code, body, _, _ in results:
        if name not in indexes:
            continue
        sel, k = meta
        if code != 200:
            raise AssertionError(f"{name}: query answered {code}: {body}")
        ids = _decode_b64(body, "indices_b64", "<i4")
        dist = _decode_b64(body, "distances_b64", "<f4")
        ok = False
        for kk in sorted({k, 10, 32} - {kk for kk in (10, 32) if kk < k}):
            wi, wd = indexes[name].search(Q[sel], kk)
            wi, wd = wi[:, :k], wd[:, :k]
            if rtol is None:
                ok = np.array_equal(ids, wi) and np.array_equal(dist, wd)
            else:
                # an id may differ only where the distances agree
                ok = np.allclose(dist, wd, rtol=rtol, atol=0.0)
            if ok:
                break
        if not ok:
            raise AssertionError(f"{name}: a query answer differs from the index's own "
                                 f"search of its rows (k={k})")
        checked += 1
    return checked


def _lat(ms):
    ms = np.asarray(ms, np.float64)
    return {"p50_request_ms": float(np.percentile(ms, 50)),
            "p99_request_ms": float(np.percentile(ms, 99)), "requests": int(ms.size)}


def _predict_limit(got, want):
    """(max |diff| / the row's largest magnitude, top-1 equal outside
    near-ties) of two (rows, classes) answers."""
    err = float((np.abs(got - want).max(axis=1) / np.abs(want).max(axis=1)).max())
    top2 = np.sort(want, axis=1)[:, -2:]
    clear = (top2[:, 1] - top2[:, 0]) > TOP1_GAP
    same = np.array_equal(got.argmax(1)[clear], want.argmax(1)[clear])
    return err, same


def model_server_phase(torch, dev, card, kept):
    """VGG16 int4 predict in three encodings and :query on the PQ and IVF-PQ
    indexes of 7, behind one ModelServer, over HTTP; then the status-code
    taxonomy on the card. Returns the phase's kernel launches, the float32
    net and its calibration record (the hot_swap phase's)."""
    from deeplearning4j_tpu_torch.models import VGG16
    from deeplearning4j_tpu_torch.quant import calibrate
    from deeplearning4j_tpu_torch.serving import ModelServer
    from deeplearning4j_tpu_torch.serving.wire import encode_array

    t_phase = time.perf_counter()
    rng = np.random.default_rng(0)
    net = VGG16(input_shape=(VGG_SIDE, VGG_SIDE, 3)).init(device=dev)
    rec = calibrate(net, [rng.standard_normal((8, VGG_SIDE, VGG_SIDE, 3), dtype=np.float32)
                          for _ in range(2)])
    srv = ModelServer(port=0, batch_limit=MS_BATCH_LIMIT, default_deadline_ms=MS_DEADLINE_MS)
    ep = srv.add_model("vgg16", net, quantize=rec, weight_bits=4,
                       warmup_example=np.zeros((1, VGG_SIDE, VGG_SIDE, 3), np.float32))
    ieps = {name: srv.add_index(name, kept[name], k_max=128) for name in ("pq", "ivf_pq")}
    srv.start(warmup=False)
    BASE[0] = base = srv.address
    ready_cold = _http(base, "GET", "/readyz")[0]
    _zero_launch_counts()
    t0 = time.perf_counter()
    srv.warmup()
    warm_s = time.perf_counter() - t0
    ready_warm = _http(base, "GET", "/readyz")[0]
    if (ready_cold, ready_warm) != (503, 200):
        raise AssertionError(f"/readyz {ready_cold} before warm-up, {ready_warm} after")
    scale = ep.input_scale

    def jobs_of(cid):
        crng = np.random.default_rng(3000 + cid)
        jobs = []
        for i in range(MS_PREDICTS):
            rows = int(crng.integers(1, 5))
            x = crng.standard_normal((rows, VGG_SIDE, VGG_SIDE, 3), dtype=np.float32)
            if cid == 0 and i == 0:
                x = x[:1]
                jobs.append(("json", "/v1/models/vgg16:predict", {"inputs": x.tolist()}, x))
            elif i % 2:
                xq = np.clip(np.round(x / scale), -127, 127).astype(np.int8)
                jobs.append(("int8", "/v1/models/vgg16:predict", encode_array(xq),
                             xq.astype(np.float32) * np.float32(scale)))
            else:
                jobs.append(("float32", "/v1/models/vgg16:predict", encode_array(x), x))
        queries = _query_jobs(("pq", "ivf_pq"), kept["Q"], 4000 + cid)
        mixed = []
        for i in range(max(len(jobs), len(queries))):
            mixed += jobs[i:i + 1] + queries[3 * i:3 * i + 3]
        return mixed

    results, wall = _run_clients(jobs_of, MS_CLIENTS)
    launches = _launch_counts()
    st = ep.pi.stats()
    vgg_dispatches = len(st["warmed_buckets"]) + st["batches_dispatched"]
    if launches["int4_dot"] != 3 * vgg_dispatches:
        raise AssertionError(f"int4_dot launched {launches['int4_dot']} times for "
                             f"{vgg_dispatches} VGG16 dispatches (want 3 each)")
    for name, kernel in (("pq", "adc_pq"), ("ivf_pq", "adc_ivf_pq")):
        want = len(ieps[name].warmed_pairs) + ieps[name].stats()["batches_dispatched"]
        if launches[kernel] != want:
            raise AssertionError(f"{kernel} launched {launches[kernel]} times for {want} "
                                 f"{name} dispatches")
    if any(v for k, v in launches.items() if k not in ("int4_dot", "adc_pq", "adc_ivf_pq")):
        raise AssertionError(f"unexpected launches {launches}")
    # every 200 against the same rows through the endpoint's own net
    worst, predicts = 0.0, 0
    for _, label, x, code, body, _, _ in results:
        if label not in ("json", "int8", "float32"):
            continue
        if code != 200:
            raise AssertionError(f"predict ({label}) answered {code}: {body}")
        got = np.asarray(body["outputs"], np.float32)
        err, same = _predict_limit(got, ep.pi.output(x))
        if err > PREDICT_LIMIT or not same:
            raise AssertionError(f"predict ({label}): {err} of the row's largest magnitude, "
                                 f"top-1 equal {same}")
        worst, predicts = max(worst, err), predicts + 1
    queries = _hold_queries(results, kept, kept["Q"])
    by_kind = {}
    for _, label, _, _, _, ms, nbytes in results:
        by_kind.setdefault(label, []).append((ms, nbytes))
    summary = {
        "card": card, "warmup_s": warm_s, "requests": len(results),
        "requests_per_s": len(results) / wall, "wall_s": wall,
        "predict": _lat([ms for _, lab, _, _, _, ms, _ in results
                         if lab in ("json", "int8", "float32")]),
        "query": _lat([ms for _, lab, _, _, _, ms, _ in results if lab in ("pq", "ivf_pq")]),
        "bytes_per_request": {k: float(np.mean([b for _, b in v])) for k, v in by_kind.items()},
        "p50_ms_by_kind": {k: float(np.median([m for m, _ in v])) for k, v in by_kind.items()},
        "batch_occupancy": st["batch_size"], "vgg16_dispatches": vgg_dispatches,
        "bucket_dispatches": st["bucket_dispatches"],
        "unwarmed_dispatches": st["unwarmed_dispatches"],
        "launches": {k: launches[k] for k in ("int4_dot", "adc_pq", "adc_ivf_pq")},
        "predicts_checked": predicts, "queries_checked": queries,
        "predict_max_err_of_row_max": worst,
    }
    summary["taxonomy"] = _taxonomy_on_card(srv, ep, dev)
    srv.stop(drain=True, drain_timeout_s=60)
    print("model_server " + json.dumps(summary), flush=True)
    print(f"model_server phase ran {time.perf_counter() - t_phase:.1f} s", flush=True)
    return summary["launches"], net, rec


def _taxonomy_on_card(srv, ep, dev):
    """400, 404, 413, a 429 burst behind a held dispatch, 504 on an expired
    deadline, 503 while draining, and /metrics, against the served VGG16."""
    from deeplearning4j_tpu_torch.parallel import ParallelInference
    from deeplearning4j_tpu_torch.serving.wire import encode_array

    base = srv.address
    x = np.zeros((1, VGG_SIDE, VGG_SIDE, 3), np.float32)
    got = {}
    got["malformed"] = _http(base, "POST", "/v1/models/vgg16:predict", b"not json")[:2]
    got["unknown"] = _http(base, "POST", "/v1/models/nope:predict", encode_array(x))[:2]
    got["too_large"] = _header_only_post(srv.port, "/v1/models/vgg16:predict",
                                         srv.max_body_bytes + 1)
    gated = GatedModel(ep.pi.model)
    gpi = ParallelInference(gated, batch_limit=1, queue_depth=2, queue_put_timeout_ms=0.0,
                            device=dev)
    gep = srv.add_model("vgg16_gated", gpi, default_deadline_ms=600_000)
    path = "/v1/models/vgg16_gated:predict"
    held, threads = [], []

    def bg(body):
        t = threading.Thread(target=lambda: held.append(_http(base, "POST", path, body)[:3]))
        t.start()
        threads.append(t)

    gated.gate.clear()
    bg(encode_array(x))
    _wait_for(gated.entered.is_set, "the held dispatch")
    bg(encode_array(x))
    bg(encode_array(x))
    _wait_for(lambda: gpi.stats()["queue"]["size"] == 2, "a full queue")
    burst = [_http(base, "POST", path, encode_array(x))[:3] for _ in range(4)]
    got["burst"] = [(c, b.get("reason"), "Retry-After" in h) for c, b, h in burst]
    gated.gate.set()
    for t in threads:
        t.join(600)
    got["held_served"] = sorted(c for c, _, _ in held)
    gated.gate.clear()
    gated.entered.clear()
    held.clear()
    bg(encode_array(x))
    _wait_for(gated.entered.is_set, "the held dispatch")
    bg(dict(encode_array(x), deadline_ms=50))
    _wait_for(lambda: gpi.stats()["queue"]["size"] == 1, "the queued request")
    time.sleep(0.1)
    gated.gate.set()
    for t in threads:
        t.join(600)
    got["expired"] = sorted((c, b.get("reason")) for c, b, _ in held)
    if not srv.drain(timeout_s=120):
        raise AssertionError("drain did not finish")
    got["draining"] = _http(base, "POST", "/v1/models/vgg16:predict", encode_array(x))[:2]
    got["draining_readyz"] = _http(base, "GET", "/readyz")[0]
    srv.undrain()
    code, text = _http(base, "GET", "/metrics")[:2]
    gpi.shutdown()
    want = {"malformed": (400, "bad_request"), "unknown": (404, "unknown_model"),
            "too_large": (413, "body_too_large"), "draining": (503, "draining")}
    for key, (wcode, reason) in want.items():
        if got[key][0] != wcode or got[key][1].get("reason") != reason:
            raise AssertionError(f"{key}: {got[key]}, want {wcode} {reason}")
    if got["burst"] != [(429, "shed", True)] * 4 or got["held_served"] != [200, 200, 200]:
        raise AssertionError(f"429 burst: {got['burst']}, held {got['held_served']}")
    if got["expired"] != [(200, None), (504, "deadline_expired")]:
        raise AssertionError(f"expired deadline: {got['expired']}")
    if got["draining_readyz"] != 503:
        raise AssertionError("/readyz while draining answered "
                             f"{got['draining_readyz']}")
    names = ("serving_http_requests", "serving_requests_shed", "serving_requests_expired",
             "serving_drain_rejected", "serving_request_ms", "serving_batch_occupancy",
             "serving_queue_depth", "serving_inflight_requests", "serving_retrieval_requests")
    missing = [n for n in names if n not in text]
    if code != 200 or missing:
        raise AssertionError(f"/metrics {code}, missing {missing}")
    return {k: (v[0] if isinstance(v, tuple) else v) for k, v in got.items()}


def _perturb(torch, net, seed):
    """Every float weight times (1 + SWAP_PERTURB * N(0, 1)), in place, from
    a seeded generator on the net's device."""
    from deeplearning4j_tpu_torch.nn.tree import tree_leaves

    gen = torch.Generator(device=net.device)
    gen.manual_seed(seed)
    with torch.no_grad():
        for w in tree_leaves(net.params):
            if w.is_floating_point():
                w.mul_(1.0 + SWAP_PERTURB * torch.randn(w.shape, generator=gen,
                                                        device=w.device, dtype=w.dtype))


def hot_swap_phase(torch, dev, card, net, rec):
    """VGG16 float32 step 1 in a CheckpointManager, served int4; step 2
    committed and swapped in by hand under the load of MS_CLIENTS clients;
    a torn step 3 neither re-swaps nor downgrades."""
    from deeplearning4j_tpu_torch.checkpoint import CheckpointManager
    from deeplearning4j_tpu_torch.checkpoint.faults import tear_file
    from deeplearning4j_tpu_torch.serving import ModelServer
    from deeplearning4j_tpu_torch.serving.wire import encode_array

    t_phase = time.perf_counter()
    workdir = tempfile.mkdtemp(prefix="chip_smoke_swap_")
    try:
        writer = CheckpointManager(workdir, device=dev, async_write=False,
                                   save_updater=False)
        net.iteration = 1
        t0 = time.perf_counter()
        writer.save(net)
        commit_s = time.perf_counter() - t0
        ckpt_bytes = writer.checkpoints()[-1]["size"]
        reader = CheckpointManager(workdir, device=dev)
        srv = ModelServer(port=0, batch_limit=MS_BATCH_LIMIT, default_deadline_ms=MS_DEADLINE_MS)
        ep = srv.add_model("vgg16", reader.restore_latest(load_updater=False), quantize=rec,
                           weight_bits=4, checkpoint_manager=reader,
                           warmup_example=np.zeros((1, VGG_SIDE, VGG_SIDE, 3), np.float32))
        srv.start(warmup=False)
        BASE[0] = srv.address
        _zero_launch_counts()
        srv.warmup()
        X = np.random.default_rng(7).standard_normal((MS_CLIENTS, VGG_SIDE, VGG_SIDE, 3),
                                                     dtype=np.float32)
        ref1 = ep.pi.output(X)
        stop = threading.Event()
        swap_done = [float("inf")]

        def jobs_of(cid):
            while not stop.is_set():
                yield ("predict", "/v1/models/vgg16:predict", encode_array(X[cid:cid + 1]),
                       time.perf_counter())

        box = []
        runner = threading.Thread(target=lambda: box.append(_run_clients(jobs_of, MS_CLIENTS)))
        runner.start()
        time.sleep(SWAP_LOAD_S)
        _perturb(torch, net, seed=2)
        net.iteration = 2
        writer.save(net)
        int4_before = _launch_counts()["int4_dot"]
        t0 = time.perf_counter()
        swapped = ep.pi.poll_checkpoint()
        swap_s = time.perf_counter() - t0
        swap_done[0] = time.perf_counter()
        time.sleep(SWAP_LOAD_S)
        stop.set()
        runner.join(900)
        results, wall = box[0]
        launches = _launch_counts()
        st = ep.pi.stats()
        ref2 = ep.pi.output(X)
        if not swapped or st["hot_swap"]["swaps"] != 1 \
                or st["hot_swap"]["current_checkpoint_step"] != 2:
            raise AssertionError(f"hot swap: {swapped}, {st['hot_swap']}")
        dispatches = len(st["warmed_buckets"]) + sum(st["bucket_dispatches"].values())
        if launches["int4_dot"] != 3 * dispatches or launches["int4_dot"] <= int4_before:
            raise AssertionError(f"int4_dot launched {launches['int4_dot']} times for "
                                 f"{dispatches} dispatches ({int4_before} before the swap)")
        sep = [_predict_limit(ref2[i:i + 1], ref1[i:i + 1])[0] for i in range(MS_CLIENTS)]
        if min(sep) <= PREDICT_LIMIT:
            raise AssertionError(f"step 1 and step 2 answers too close: {sep}")
        olds = news = 0
        for cid, _, sent, code, body, ms, _ in results:
            if code != 200:
                raise AssertionError(f"a request failed across the swap: {code} {body}")
            got = np.asarray(body["outputs"], np.float32)
            e1 = _predict_limit(got, ref1[cid:cid + 1])
            e2 = _predict_limit(got, ref2[cid:cid + 1])
            is1, is2 = e1[0] <= PREDICT_LIMIT and e1[1], e2[0] <= PREDICT_LIMIT and e2[1]
            if is1 == is2:
                raise AssertionError(f"an answer is neither step 1's nor step 2's "
                                     f"({e1[0]}, {e2[0]})")
            if sent > swap_done[0] and not is2:
                raise AssertionError("a request sent after the swap got step 1's answer")
            olds, news = olds + is1, news + is2
        if not olds or not news:
            raise AssertionError(f"{olds} step-1 and {news} step-2 answers")
        # a torn newest checkpoint neither re-swaps nor downgrades
        _perturb(torch, net, seed=3)
        net.iteration = 3
        torn = writer.save(net)
        tear_file(os.path.join(workdir, torn))
        if ep.pi.poll_checkpoint() or ep.pi.stats()["hot_swap"]["current_checkpoint_step"] != 2:
            raise AssertionError("the torn checkpoint re-swapped or downgraded")
        if _predict_limit(ep.pi.output(X), ref2)[0] > PREDICT_LIMIT:
            raise AssertionError("the served answers moved after the torn poll")
        srv.stop(drain=True, drain_timeout_s=60)
        writer.close()
        reader.close()
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    swap_window = [ms for _, _, sent, _, _, ms, _ in results
                   if sent <= swap_done[0] and sent + ms / 1e3 >= swap_done[0] - swap_s]
    summary = {"card": card, "checkpoint_bytes": ckpt_bytes, "commit_s": commit_s,
               "swap_restore_quantize_s": swap_s, "requests": len(results),
               "step1_answers": olds, "step2_answers": news, "requests_per_s": len(results) / wall,
               **_lat([r[5] for r in results]),
               "max_request_ms": float(max(r[5] for r in results)),
               "max_request_ms_across_swap": float(max(swap_window, default=0.0)),
               "int4_dot_launches": launches["int4_dot"], "vgg16_dispatches": dispatches,
               "step_gap_of_row_max": min(sep)}
    print("hot_swap " + json.dumps(summary), flush=True)
    print(f"hot_swap phase ran {time.perf_counter() - t_phase:.1f} s", flush=True)
    return {k: launches[k] for k in ("int4_dot", "adc_pq", "adc_ivf_pq")}


def _sequential_decode(torch, net, prompt, n_tokens, vocab):
    """Greedy decode through rnn_time_step on the card: the tokens and, per
    token, the gap between the top two log-probabilities."""
    eye = torch.eye(vocab, device=net.device)
    net.rnn_clear_previous_state()
    out = net.rnn_time_step(eye[torch.tensor(prompt, device=net.device)][None])[:, -1]
    toks, gaps = [], []
    for _ in range(n_tokens):
        top = torch.topk(torch.log(out[0]), 2)
        host = torch.cat([top.values, top.indices[:1].to(top.values.dtype)]).cpu().numpy()
        idx = int(host[2])
        toks.append(idx)
        gaps.append(float(host[0] - host[1]))
        if len(toks) < n_tokens:
            out = net.rnn_time_step(eye[idx][None])
    net.rnn_clear_previous_state()
    return toks, gaps


def _sse_tokens(raw: str):
    events = []
    for block in raw.strip().split("\n\n"):
        lines = dict(ln.split(": ", 1) for ln in block.split("\n"))
        events.append((lines["event"], json.loads(lines["data"])))
    return [d["id"] for k, d in events if k == "token"], events[-1][0]


def decode_phase(torch, dev, card):
    """The char-RNN behind add_generator: 32 greedy sessions against the
    sequential rnn_time_step loop, TTFT / ITL, dispatch shapes and host
    reads, :generate over SSE and JSON, and a "carry" hot swap."""
    import http.client

    from deeplearning4j_tpu_torch.checkpoint import CheckpointManager
    from deeplearning4j_tpu_torch.models import TextGenerationLSTM
    from deeplearning4j_tpu_torch.serving import ModelServer

    t_phase = time.perf_counter()
    _zero_launch_counts()
    vocab = 47
    net = TextGenerationLSTM(total_unique_characters=vocab).init(device=dev)
    rng = np.random.default_rng(0)
    prompts = [[int(t) for t in rng.integers(0, vocab, DECODE_PROMPT)]
               for _ in range(DECODE_SESSIONS)]
    _sequential_decode(torch, net, prompts[0], 4, vocab)  # first touch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    seq = [_sequential_decode(torch, net, p, DECODE_TOKENS, vocab) for p in prompts]
    seq_s = time.perf_counter() - t0

    srv = ModelServer(port=0, default_deadline_ms=MS_DEADLINE_MS)
    gep = srv.add_generator("char", net, max_sessions=DECODE_SESSIONS, min_slots=8,
                            prefill_buckets=DECODE_BUCKETS, seed=1)
    eng = gep.engine
    srv.start(warmup=False)
    t0 = time.perf_counter()
    srv.warmup()
    warm_s = time.perf_counter() - t0
    st0 = eng.stats()
    t0 = time.perf_counter()
    sessions = [eng.open_session(p, max_tokens=DECODE_TOKENS, temperature=0.0)
                for p in prompts]
    got = []
    for s in sessions:
        evs = list(s.events(token_deadline_s=120.0))
        if evs[-1] != {"type": "done", "reason": "max_tokens", "tokens": DECODE_TOKENS}:
            raise AssertionError(f"decode session ended {evs[-1]}")
        got.append([e["id"] for e in evs if e["type"] == "token"])
    wave_s = time.perf_counter() - t0
    st = eng.stats()
    near_ties = 0
    for toks, (want, gaps) in zip(got, seq):
        # from the first near-tie on, the two may pick different tokens
        tie = next((i for i, g in enumerate(gaps) if g <= DECODE_TIE), len(want))
        near_ties += tie < len(want)
        if toks[:tie] != want[:tie]:
            raise AssertionError(f"engine tokens differ from sequential rnn_time_step "
                                 f"before the first near-tie (position {tie})")
    if st["new_shapes_after_warmup"] != 0:
        raise AssertionError(f"{st['new_shapes_after_warmup']} new dispatch shapes after warm-up")
    if st["host_reads"] != st["steps"] + st["admissions"]:
        raise AssertionError(f"{st['host_reads']} host reads for {st['steps']} steps and "
                             f"{st['admissions']} admissions")
    ttft = [(s.first_token_at - s.opened_at) * 1e3 for s in sessions]
    itl = [d * 1e3 for s in sessions for d in np.diff(s.token_times)]

    # :generate over HTTP, SSE and JSON, against a session of the engine
    direct = eng.open_session(prompts[0], max_tokens=16, temperature=0.0)
    want16 = [e["id"] for e in direct.events(120.0) if e["type"] == "token"]
    conn = http.client.HTTPConnection("127.0.0.1", srv.port, timeout=120)
    conn.request("POST", "/v1/models/char:generate", body=json.dumps(
        {"prompt_ids": prompts[0], "max_tokens": 16, "temperature": 0.0}).encode())
    r = conn.getresponse()
    sse_toks, last = _sse_tokens(r.read().decode())
    conn.close()
    code, body = _http(srv.address, "POST", "/v1/models/char:generate",
                       {"prompt_ids": prompts[0], "max_tokens": 16, "temperature": 0.0,
                        "stream": False})[:2]
    if r.status != 200 or last != "done" or code != 200 \
            or not (sse_toks == body["token_ids"] == want16):
        raise AssertionError(f":generate SSE {r.status} {sse_toks} / JSON {code} "
                             f"{body} / engine {want16}")

    # one "carry" swap mid-generation, no session lost
    workdir = tempfile.mkdtemp(prefix="chip_smoke_decode_")
    try:
        cm = CheckpointManager(workdir, device=dev, async_write=False)
        cm.save(net)
        eng.start_hot_swap(cm, poll_secs=None, policy="carry")
        live = [eng.open_session(p, max_tokens=DECODE_SWAP_TOKENS, temperature=0.0)
                for p in prompts[:DECODE_SWAP_SESSIONS]]
        _wait_for(lambda: min(len(s.generated) for s in live) >= 8, "tokens before the swap")
        newer = net.to(dev)
        _perturb(torch, newer, seed=5)
        newer.iteration = 1
        cm.save(newer)
        t0 = time.perf_counter()
        if not eng.poll_checkpoint():
            raise AssertionError("the decode hot swap was not staged")
        stage_s = time.perf_counter() - t0
        at_swap = [len(s.generated) for s in live]
        ends = [list(s.events(120.0))[-1] for s in live]
        if any(e != {"type": "done", "reason": "max_tokens", "tokens": DECODE_SWAP_TOKENS}
               for e in ends) or eng.stats()["hot_swaps"] != 1 \
                or max(at_swap) >= DECODE_SWAP_TOKENS:
            raise AssertionError(f"sessions across the swap ended {ends}, "
                                 f"{eng.stats()['hot_swaps']} swaps")
        cm.close()
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    srv.stop(drain=True, drain_timeout_s=60)
    launches = _launch_counts()
    if any(launches.values()):
        raise AssertionError(f"a kernel of the port launched in the decode phase: {launches}")
    tokens = DECODE_SESSIONS * DECODE_TOKENS
    summary = {
        "card": card, "sessions": DECODE_SESSIONS, "tokens_each": DECODE_TOKENS,
        "prompt": DECODE_PROMPT, "warmup_s": warm_s,
        "engine_tokens_per_s": tokens / wave_s, "sequential_tokens_per_s": tokens / seq_s,
        "engine_wave_s": wave_s, "sequential_s": seq_s,
        "ttft_p50_ms": float(np.percentile(ttft, 50)),
        "ttft_p99_ms": float(np.percentile(ttft, 99)),
        "itl_p50_ms": float(np.percentile(itl, 50)), "itl_p99_ms": float(np.percentile(itl, 99)),
        "sessions_with_near_tie": near_ties, "steps": st["steps"] - st0["steps"],
        "host_reads": st["host_reads"], "dispatch_shapes": st["dispatch_shapes"],
        "new_shapes_after_warmup": st["new_shapes_after_warmup"],
        "http_tokens": len(sse_toks), "swap_stage_s": stage_s,
        "tokens_at_swap": [min(at_swap), max(at_swap)], "launches": launches,
    }
    print("decode " + json.dumps(summary), flush=True)
    print(f"decode phase ran {time.perf_counter() - t_phase:.1f} s", flush=True)


class SharedIvfCells:
    """The IVF family's coarse cells trained once for the retrieval corpus.
    IVFPQIndex (retrieval) and the four IVFIndex variants (ivf) each call
    ``retrieval.index._train_cells`` on the same corpus object with the
    same cell count, sample size, iterations and seed, and get the same
    cells (k-means++ seeding in host numpy, then Lloyd steps on the card,
    deterministic); the seeding alone is 10-30 s of a build. While this is
    installed the first call trains and every later one with the same
    arguments on the same corpus gets a copy; ``trained`` / ``reused``
    count them."""

    def __init__(self):
        from deeplearning4j_tpu_torch.retrieval import index, pq
        self._modules = (index, pq)
        self._train = index._train_cells
        self._memo = {}
        self.trained = self.reused = 0

    def __call__(self, v, n_cells, train_size, max_iterations, seed, device):
        key = (v.ctypes.data, v.shape, n_cells, train_size, max_iterations, seed, str(device))
        hit = self._memo.get(key)
        if hit is None or hit[0] is not v:
            self.trained += 1
            hit = self._memo[key] = (v, self._train(v, n_cells, train_size, max_iterations,
                                                    seed, device))
        else:
            self.reused += 1
        centroids, assign = hit[1]
        return centroids.copy(), assign.copy()

    def install(self):
        for mod in self._modules:
            mod._train_cells = self
        return self

    def remove(self):
        for mod in self._modules:
            mod._train_cells = self._train


def ivf_phase(torch, dev, card, kept):
    """IVFIndex(V) and IVFIndex(V, int8=True) on the corpus of 7, dense and
    CSR, each served over HTTP under the model_server load, recall@10
    against the exact ids of 7, dense == CSR, and card against CPU. Each
    build takes the cells retrieval's IVF-PQ trained (SharedIvfCells), so
    ``build_s`` times the lists, layouts and tables."""
    from deeplearning4j_tpu_torch.retrieval import IVFIndex
    from deeplearning4j_tpu_torch.serving import ModelServer

    t_phase = time.perf_counter()
    V, Q, exact = kept["V"], kept["Q"], kept["exact_ids"]
    answers, rows = {}, []
    with tempfile.TemporaryDirectory(dir=str(_build_dir())) as tmpdir:
        for name, kw in IVF_VARIANTS:
            _zero_launch_counts()
            t0 = time.perf_counter()
            ix = IVFIndex(V, device=dev, **kw)
            torch.cuda.synchronize()
            build_s = time.perf_counter() - t0
            srv = ModelServer(port=0, default_deadline_ms=MS_DEADLINE_MS)
            iep = srv.add_index(name, ix, k_max=128)
            srv.start(warmup=False)
            BASE[0] = srv.address
            t0 = time.perf_counter()
            srv.warmup()
            warm_s = time.perf_counter() - t0
            results, wall = _run_clients(
                lambda cid: _query_jobs((name,), Q, 5000 + cid), MS_CLIENTS)
            srv.stop(drain=True, drain_timeout_s=60)
            # the batched scorers' products round with the batch's shape
            # (cuBLAS picks its algorithm by shape): 7's near-tie rule
            checked = _hold_queries(results, {name: ix}, Q, rtol=NEAR_TIE_RTOL)
            got_i, got_d = _search_all(ix, Q, 10)
            answers[name] = (got_i, got_d)
            recall = float(np.mean([len(np.intersect1d(g, w)) / 10.0
                                    for g, w in zip(got_i, exact)]))
            codec = "int8" if kw.get("int8") else "fp32"
            gate = IVF_RECALL_GATES[codec]
            launches = _launch_counts()
            st = ix.stats()
            summary = {"card": card, "index": name, "build_s": build_s, "warmup_s": warm_s,
                       "memory_bytes": st["memory_bytes"], "cap": st["cap"],
                       "cand_pad": st.get("cand_pad"), "n_cells": st["n_cells"],
                       "nprobe": st["nprobe"], **_lat([r[5] for r in results]),
                       "queries_per_s": sum(len(r[2][0]) for r in results) / wall,
                       "requests_checked": checked, "recall_at_10": recall,
                       "recall_gate": gate, "jax_recall_at_10": JAX_IVF_RECALL[codec],
                       "launches": launches,
                       "card_vs_cpu": card_vs_cpu_index(torch, name, ix, Q, tmpdir)}
            print("ivf " + json.dumps(summary), flush=True)
            rows.append(summary)
            if any(launches.values()):
                raise AssertionError(f"{name}: a kernel launched: {launches}")
            if recall < gate:
                raise AssertionError(f"{name}: recall@10 {recall:.4f} under the gate {gate}")
            del ix, iep, srv
            torch.cuda.empty_cache()
    for dense, csr in (("ivf", "ivf_csr"), ("ivf_int8", "ivf_int8_csr")):
        if not (np.array_equal(answers[dense][0], answers[csr][0])
                and np.array_equal(answers[dense][1], answers[csr][1])):
            raise AssertionError(f"{dense} and {csr} answer differently")
    print(f"ivf phase ran {time.perf_counter() - t_phase:.1f} s", flush=True)
    return rows


# ------------------------------------------------------------- data tier
# data_tier: images written as uint8 shards (synthetic_images at ResNet50's
# width, 10 classes padded to the 1,000-way head), read back through the
# sharded reader; records a shard = the batch, so each batch is one shard
DATA_TRAIN, DATA_VAL, DATA_CLASSES, DATA_SHARD = 1024, 256, 10, 128
# (MaxEpochs 4 until PR 21; 2 since, to keep the run inside its time: the
# same conditions, checks and replay, two host-bound epochs fewer)
DATA_EPOCHS, DATA_PATIENCE = 2, 2
DATA_CROP, DATA_FLIP = 16, 0.5
IMAGENET_MEAN, IMAGENET_STD = (0.485, 0.456, 0.406), (0.229, 0.224, 0.225)
# three steps with and without prefetch; crash-exact resume: kill at step 6
# of one 8-batch epoch, checkpointing every step (restored at step 5)
DATA_SAME_STEPS, DATA_KILL = 3, 6
# the data-wait reading: epochs per setting (prefetch off, then on)
DATA_WAIT_EPOCHS = 3
COPY_REPS = 10
# lenet_gates: the MNIST-shaped sets as idx files, the test set also as a
# CSV (label first, pixels as 0-255 integers); LeNet at batch 64 for at
# most 2 epochs (cut from 3 to hold the script's time; 1,876 steps, where
# the readings below put the sound lowering at 7.7e-8), validation on the CSV in batches of 100, the gate's
# calibration on 4 training batches, accuracy floor and agreement floor
GATE_TRAIN, GATE_TEST, GATE_BATCH, GATE_VAL_BATCH = 60000, 10000, 64, 100
GATE_EPOCHS, GATE_CALIB_BATCHES, GATE_ACC, GATE_AGREE = 2, 4, 0.95, 0.95
# the gate's loss term. The synthetic set is separable: the fp32 mean NLL is
# ~3e-4 after 20 steps and 1e-10..1e-8 once trained, and the sound int4
# lowering moves it by 0.27x to 34x of itself (tools/int4_gate_readings.py
# on the CPU), so the default 1% relative loss budget cannot hold. The gate
# holds the default top-1 budget, the agreement floor and the absolute loss
# delta in nats under GATE_LOSS_ABS. That tool's readings on trained nets
# (200, 938 and 1876 steps): sound 7.5e-9 / 5.5e-9 / 7.7e-8, the control
# below 1.2e-6 / 6.6e-6 / 3.5e-6; the limit sits between them, a factor of
# about 4 from each.
GATE_LOSS_ABS = 3e-7
# the control the gate must reject: the int4 layers' last GATE_CONTROL_TAIL
# inputs dropped, as a kernel that lost its last k tile would compute
GATE_CONTROL_TAIL = 64
# LeNet's int4 products at the validation batch: (b, n, d) of the dense
# layer (7 x 7 x 50 inputs after two SAME convolutions and pools) and the
# output layer
LENET_INT4_SHAPES = [(GATE_VAL_BATCH, 500, 2450), (GATE_VAL_BATCH, 10, 500)]


def _write_image_shards(torch, root):
    """The train and validation corpora as uint8 shard files under
    ``root`` (a LocalFSBackend each); returns (train source, validation
    source, bytes on disk)."""
    from deeplearning4j_tpu_torch.checkpoint.storage import LocalFSBackend
    from deeplearning4j_tpu_torch.datasets import synthetic_images, write_shards

    out, total = [], 0
    for name, n, seed in (("train", DATA_TRAIN, 0), ("val", DATA_VAL, 1)):
        x, y = synthetic_images(n, TRAIN_SIDE, 3, num_classes=DATA_CLASSES, seed=seed)
        x = np.rint(x * 255.0).astype(np.uint8)
        labels = np.zeros((n, 1000), np.float32)
        labels[:, :DATA_CLASSES] = y
        backend = LocalFSBackend(os.path.join(root, name))
        out.append(write_shards(backend, f"{name}/", x, labels, records_per_shard=DATA_SHARD))
        total += sum(os.path.getsize(os.path.join(d, f))
                     for d, _, files in os.walk(os.path.join(root, name)) for f in files)
        del x
    return out[0], out[1], total


def _image_reader(source, bind_zero=False):
    """ShardedDataset(source) -> ShardedReader -> ImagePreProcessingScaler
    (uint8 to [0, 1] on the host); ``bind_zero`` pins the epoch order."""
    from deeplearning4j_tpu_torch.datasets import ImagePreProcessingScaler, ShardedDataset

    reader = ShardedDataset(source=source, batch_size=TRAIN_BATCH, seed=0).reader()
    reader.set_pre_processor(ImagePreProcessingScaler())
    return reader.bind_epoch(lambda: 0) if bind_zero else reader


def _fresh_source(source):
    from deeplearning4j_tpu_torch.datasets import ShardFileSource
    return ShardFileSource(source.store, source.prefix)


class _StepLog:
    """Listener: each step's loss tensor (no host read) and the bn
    launch counters after it."""

    def __init__(self):
        self.losses, self.bwd = [], []

    def iteration_done(self, net, iteration, epoch):
        from deeplearning4j_tpu_torch.perf.kernels import bn_act
        self.losses.append(net._score)
        self.bwd.append(bn_act.bwd_launches)

    def on_epoch_start(self, net):
        pass

    def on_epoch_end(self, net):
        pass


def _data_wait_run(torch, dev, train_src, prefetch) -> dict:
    """DATA_WAIT_EPOCHS epochs of a fresh network through
    fit(AsyncDataSetIterator(reader), prefetch=...) with the tracer on.
    Each epoch starts a new reader thread, so its first batch waits for a
    cold start: the first waits are reported apart, and the steady share is
    the other waits over the wall time less the first waits."""
    from deeplearning4j_tpu_torch.datasets import AsyncDataSetIterator, ImageAugmentation
    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
    from deeplearning4j_tpu_torch.obs.trace import configure_tracer, get_tracer

    net = ComputationGraph(resnet50_train_conf(), dev).init()
    net.set_augmentation(ImageAugmentation(DATA_CROP, DATA_FLIP, IMAGENET_MEAN, IMAGENET_STD))
    waits = []

    def sink(rec):
        if rec["kind"] == "span" and rec["name"] == "train.data_wait":
            waits.append(rec["dur_ms"])

    tracer = get_tracer()
    enabled = tracer.enabled
    configure_tracer(enabled=True)
    tracer.add_sink(sink)
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        net.fit(AsyncDataSetIterator(_image_reader(train_src)), num_epochs=DATA_WAIT_EPOCHS,
                prefetch=prefetch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    finally:
        tracer.remove_sink(sink)
        configure_tracer(enabled=enabled)
    steps = net.iteration
    del net
    torch.cuda.empty_cache()
    per_epoch = DATA_TRAIN // TRAIN_BATCH
    if steps != DATA_WAIT_EPOCHS * per_epoch or len(waits) != steps:
        raise AssertionError(f"data_tier: {steps} steps and {len(waits)} data waits in "
                             f"{DATA_WAIT_EPOCHS} epochs of {per_epoch} batches")
    first = waits[::per_epoch]
    rest_wall = wall_ms - sum(first)
    return {"prefetch": prefetch, "epochs": DATA_WAIT_EPOCHS, "steps": steps,
            "wall_ms": wall_ms, "images_per_s": steps * TRAIN_BATCH / (wall_ms / 1e3),
            "first_wait_ms": first, "data_wait_ms": sum(waits),
            "data_wait_share": sum(waits) / wall_ms,
            "steady_data_wait_share": (sum(waits) - sum(first)) / rest_wall,
            "images_per_s_without_first_waits": steps * TRAIN_BATCH / (rest_wall / 1e3)}


def _copy_rates(torch, dev) -> dict:
    """Host-to-card copy rate of one batch (128 x 224 x 224 x 3 float32) from
    a pinned buffer on a copy stream and from pageable memory, CUDA events
    over COPY_REPS copies each."""
    shape = (TRAIN_BATCH, TRAIN_SIDE, TRAIN_SIDE, 3)
    pinned = torch.ones(shape, pin_memory=True)
    pageable = torch.ones(shape)
    dst = torch.empty(shape, device=dev)
    nbytes = pinned.numel() * 4
    out = {"batch_mb": nbytes / 1e6}
    stream = torch.cuda.Stream(dev)
    for name, src in (("pinned", pinned), ("pageable", pageable)):
        with torch.cuda.stream(stream):
            dst.copy_(src, non_blocking=True)
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record(stream)
            for _ in range(COPY_REPS):
                dst.copy_(src, non_blocking=True)
            end.record(stream)
        end.synchronize()
        ms = start.elapsed_time(end) / COPY_REPS
        out[f"{name}_ms"] = ms
        out[f"{name}_gb_per_s"] = nbytes / (ms / 1e3) / 1e9
    return out


def _replay_conditions(conditions, scores, total_epochs) -> tuple:
    """(details, epochs) at which fresh copies of the epoch conditions stop
    on this score sequence: the trainer's rule, replayed on the host."""
    import copy
    conds = [copy.deepcopy(c) for c in conditions]
    for c in conds:
        c.initialize()
    last = None
    for epoch in range(total_epochs):
        if epoch in scores:
            last = scores[epoch]
        for c in conds:
            if getattr(c, "requires_score", True) and epoch not in scores:
                continue
            if c.terminate(epoch, last):
                return type(c).__name__, epoch + 1
    return None, total_epochs


def data_tier_phase(torch, dev, card, workdir) -> dict:
    """ResNet50 (the training phase's network) fed from disk: uint8 shards
    read by ShardedDataset -> ShardedReader -> ImagePreProcessingScaler ->
    AsyncDataSetIterator, augmented on the card (crop 16, flip 0.5,
    ImageNet mean / std), batches staged by DevicePrefetchIterator, trained
    by EarlyStoppingTrainer (MaxEpochs DATA_EPOCHS, ScoreImprovement 2, the default
    validation loss, LocalFileModelSaver) under cudnn.deterministic. Held:
    every loss finite and the last epoch's mean below the first's; 53 + 53
    bn launches a training step (and 53 forward a validation batch); the
    result consistent with its score_vs_epoch (best epoch = argmin, the
    conditions replayed stop where it stopped); the saved best model
    reloaded scores the best score bitwise; evaluate's confusion matrix
    (counted on the card) equal to one from output() on the host; every
    batch a training step received was on the card. Then: three steps with and without
    prefetch bitwise equal; crash-exact resume through the reader (kill at
    step 6, restore at step 5, the resumed epoch seeks: 3 shards read) bitwise
    the uninterrupted run. Prints images/s and the train.data_wait share of
    DATA_WAIT_EPOCHS epochs without and as many with prefetch (default
    cuDNN flags; each epoch's first wait apart), and the pinned and
    pageable copy rates."""
    from deeplearning4j_tpu_torch.checkpoint import (CheckpointManager, FaultInjector,
                                                     SimulatedCrash)
    from deeplearning4j_tpu_torch.datasets import AsyncDataSetIterator, ImageAugmentation
    from deeplearning4j_tpu_torch.earlystopping import (EarlyStoppingConfiguration,
                                                        EarlyStoppingTrainer,
                                                        LocalFileModelSaver,
                                                        MaxEpochsTerminationCondition,
                                                        ScoreImprovementEpochTerminationCondition)
    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
    from deeplearning4j_tpu_torch.perf.kernels import bn_act

    t_phase = time.perf_counter()
    aug = ImageAugmentation(DATA_CROP, DATA_FLIP, IMAGENET_MEAN, IMAGENET_STD)
    t0 = time.perf_counter()
    train_src, val_src, disk_bytes = _write_image_shards(torch, os.path.join(workdir, "data"))
    write_s = time.perf_counter() - t0
    copy = _copy_rates(torch, dev)
    waits = [_data_wait_run(torch, dev, train_src, p) for p in (False, True)]

    class CardBatchTrainer(EarlyStoppingTrainer):
        """Notes, for each batch the trainer's DevicePrefetchIterator hands
        to a training step, whether every array of it is a tensor on the
        network's device."""

        def _fit_batch(self, ds):
            on_card.append(all(isinstance(t, torch.Tensor) and t.device.type == dev.type
                               for t in (ds.features, ds.labels)))
            return super()._fit_batch(ds)

    on_card = []
    flags = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    try:
        # -- the main path: early stopping over the reader, prefetch on
        net = ComputationGraph(resnet50_train_conf(), dev).init().set_augmentation(aug)
        log = _StepLog()
        net.set_listeners(log)
        conditions = [MaxEpochsTerminationCondition(DATA_EPOCHS),
                      ScoreImprovementEpochTerminationCondition(DATA_PATIENCE)]
        saver = LocalFileModelSaver(os.path.join(workdir, "best"))
        val = _image_reader(val_src, bind_zero=True)
        trainer = CardBatchTrainer(
            EarlyStoppingConfiguration(conditions, model_saver=saver), net,
            AsyncDataSetIterator(_image_reader(train_src)), val)
        _zero_launch_counts()
        t0 = time.perf_counter()
        result = trainer.fit()
        torch.cuda.synchronize()
        es_s = time.perf_counter() - t0
        fwd, bwd = bn_act.fwd_launches, bn_act.bwd_launches
        others = {k: v for k, v in _launch_counts().items()
                  if k not in ("bn_act_fwd", "bn_act_bwd") and v}
        losses = [float(v) for v in log.losses]
        steps = len(losses)
        per_epoch = DATA_TRAIN // TRAIN_BATCH
        epoch_loss = [float(np.mean(losses[i:i + per_epoch]))
                      for i in range(0, steps, per_epoch)]
        if others:
            raise AssertionError(f"data_tier: other kernels launched: {others}")
        if not all(np.isfinite(losses)) or not epoch_loss[-1] < epoch_loss[0]:
            raise AssertionError(f"data_tier: epoch losses {epoch_loss}")
        if steps != result.total_epochs * per_epoch:
            raise AssertionError(f"data_tier: {steps} steps in {result.total_epochs} epochs")
        step_bwd = np.diff([0] + log.bwd).tolist()
        if any(d != RESNET50_FUSED_BLOCKS for d in step_bwd):
            raise AssertionError(f"data_tier: bn_act_bwd launches a step {step_bwd}")
        scored = len(result.score_vs_epoch)
        val_batches = DATA_VAL // TRAIN_BATCH
        want_fwd = RESNET50_FUSED_BLOCKS * (steps + scored * val_batches)
        if bwd != RESNET50_FUSED_BLOCKS * steps or fwd != want_fwd:
            raise AssertionError(f"data_tier: bn_act {fwd} forward / {bwd} backward; want "
                                 f"{want_fwd} / {RESNET50_FUSED_BLOCKS * steps}")
        scores = result.score_vs_epoch
        best_epoch = min(scores, key=scores.get)
        if (result.best_model_epoch != best_epoch
                or result.best_model_score != scores[best_epoch]):
            raise AssertionError(f"data_tier: best epoch {result.best_model_epoch} / score "
                                 f"{result.best_model_score} vs {scores}")
        replayed = _replay_conditions(conditions, scores, DATA_EPOCHS + 1)
        if replayed != (result.termination_details, result.total_epochs):
            raise AssertionError(f"data_tier: stopped by {result.termination_details} after "
                                 f"{result.total_epochs} epochs; the conditions replayed "
                                 f"stop at {replayed}")
        if len(on_card) != steps or not all(on_card):
            raise AssertionError(f"data_tier: {on_card.count(False)} of {len(on_card)} "
                                 f"batches reached a step with arrays off {dev} "
                                 f"({steps} steps)")
        best = result.best_model
        rescored = trainer.score_calculator(best)
        if rescored != result.best_model_score:
            raise AssertionError(f"data_tier: the reloaded best model scores {rescored!r}, "
                                 f"recorded {result.best_model_score!r}")
        ev = best.evaluate(val)
        host = np.zeros((1000, 1000), np.int64)
        for ds in val:
            pred = best.output_single(ds.features).argmax(-1)
            np.add.at(host, (np.asarray(ds.labels).argmax(-1), pred), 1)
        if not np.array_equal(ev.confusion.matrix, host):
            raise AssertionError("data_tier: evaluate's confusion matrix differs from the "
                                 "host's count over output()")
        accuracy = ev.accuracy()
        result.best_model = None
        del net, best, trainer
        torch.cuda.empty_cache()

        # -- prefetch changes no math (augmentation off)
        batches = [ds for _, ds in zip(range(DATA_SAME_STEPS),
                                       _image_reader(train_src, bind_zero=True))]
        records = []
        for prefetch in (False, True):
            n2 = ComputationGraph(resnet50_train_conf(), dev).init()
            n2.fit(batches, prefetch=prefetch)
            records.append(_run_record(n2))
            del n2
            torch.cuda.empty_cache()
        diff = _differences(*records)
        if diff:
            raise AssertionError(f"data_tier: prefetch changed {len(diff)} arrays: {diff[:6]}")

        # -- crash-exact resume through the reader, augmentation and prefetch on
        def stream(src):
            return AsyncDataSetIterator(_image_reader(src))

        ref = ComputationGraph(resnet50_train_conf(), dev).init().set_augmentation(aug)
        ref.fit(stream(train_src), prefetch=True)
        ref_record = _run_record(ref)
        del ref
        torch.cuda.empty_cache()
        ck = os.path.join(workdir, "resume_ckpt")
        cm = CheckpointManager(ck, save_every_n_steps=1, keep_last=2, device=dev)
        crashed = ComputationGraph(resnet50_train_conf(), dev).init().set_augmentation(aug)
        crashed.set_listeners(FaultInjector(kill_at_step=DATA_KILL))
        try:
            crashed.fit(stream(train_src), prefetch=True, checkpoint_manager=cm)
            raise AssertionError("data_tier: the injected crash did not fire")
        except SimulatedCrash:
            pass
        cm.close()
        del crashed
        torch.cuda.empty_cache()
        resumed = CheckpointManager(ck, device=dev).restore_latest()
        rs = resumed._resume_state
        if (rs.step, rs.epoch, rs.batch_in_epoch) != (DATA_KILL - 1, 0, DATA_KILL - 1):
            raise AssertionError(f"data_tier: restored at {(rs.step, rs.epoch, rs.batch_in_epoch)}")
        if resumed.augmentation != aug:
            raise AssertionError("data_tier: the checkpoint lost the augmentation")
        src = _fresh_source(train_src)
        resumed.fit(stream(src), prefetch=True)
        diff = _differences(ref_record, _run_record(resumed))
        shards_read = src.loads
        del resumed
        torch.cuda.empty_cache()
        if diff:
            raise AssertionError(f"data_tier: the resumed run differs in {len(diff)} arrays: "
                                 f"{diff[:6]}")
        if shards_read != DATA_TRAIN // TRAIN_BATCH - (DATA_KILL - 1):
            raise AssertionError(f"data_tier: the resumed epoch read {shards_read} shards")
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = flags
        torch.cuda.empty_cache()
    summary = {
        "card": card, "train_images": DATA_TRAIN, "val_images": DATA_VAL,
        "shards": len(train_src.shard_sizes) + len(val_src.shard_sizes),
        "disk_bytes": disk_bytes, "write_shards_s": write_s,
        "data_wait": waits, "copy": copy,
        "early_stopping": {"epochs": result.total_epochs,
                           "reason": result.termination_reason,
                           "details": result.termination_details,
                           "best_epoch": result.best_model_epoch,
                           "best_score": result.best_model_score,
                           "score_vs_epoch": scores, "epoch_train_loss": epoch_loss,
                           "steps": steps, "seconds": es_s,
                           "images_per_s_with_validation": steps * TRAIN_BATCH / es_s,
                           "val_accuracy": accuracy, "reloaded_best_score": "bitwise",
                           "batches_on_card": f"{len(on_card)} of {steps}",
                           "confusion_matrix": "equal to the host count"},
        "bn_act_fwd_launches": fwd, "bn_act_bwd_launches": bwd,
        "prefetch_same_math": f"{DATA_SAME_STEPS} steps bitwise",
        "resume": {"killed_at_step": DATA_KILL, "restored_step": DATA_KILL - 1,
                   "shards_read_after_restore": shards_read, "result": "bitwise"},
        "seconds": time.perf_counter() - t_phase}
    print("data_tier " + json.dumps(summary), flush=True)
    return {"fwd": fwd, "bwd": bwd}


def _write_mnist_files(root, csv_path):
    """mnist_data's seeded synthetic sets as idx files under ``root``/mnist
    (pixels x 255, rounded, as uint8) and the test set as a CSV, label
    first."""
    import struct

    from deeplearning4j_tpu_torch.datasets import mnist_data

    os.makedirs(os.path.join(root, "mnist"), exist_ok=True)
    for stem, n, train in (("train", GATE_TRAIN, True), ("t10k", GATE_TEST, False)):
        x, y = mnist_data(n, train=train)
        pix = np.rint(x * 255.0).astype(np.uint8)
        lab = y.argmax(-1).astype(np.uint8)
        with open(os.path.join(root, "mnist", f"{stem}-images-idx3-ubyte"), "wb") as f:
            f.write(struct.pack(">IIII", 2051, n, 28, 28))
            f.write(pix.tobytes())
        with open(os.path.join(root, "mnist", f"{stem}-labels-idx1-ubyte"), "wb") as f:
            f.write(struct.pack(">II", 2049, n))
            f.write(lab.tobytes())
    np.savetxt(csv_path, np.concatenate([lab[:, None], pix], axis=1), fmt="%d",
               delimiter=",")


def _int4_gate(report):
    """The phase's gate: assert_accuracy_within at the default top-1 budget
    with the agreement floor, and the absolute loss delta under
    GATE_LOSS_ABS in place of the relative budget (see GATE_LOSS_ABS)."""
    from deeplearning4j_tpu_torch.quant.gates import assert_accuracy_within

    assert_accuracy_within(report, agreement_floor=GATE_AGREE, loss_budget=float("inf"))
    loss_delta = abs(report["quant_loss"] - report["fp32_loss"])
    if loss_delta > GATE_LOSS_ABS:
        raise AssertionError(f"|quant - fp32| mean NLL {loss_delta} > {GATE_LOSS_ABS}")
    return loss_delta


def lenet_gates_phase(torch, dev, card, workdir, flush) -> dict:
    """The DL4J early-stopping MNIST example with a quantization gate: LeNet
    (BASELINE configs[0]) trained from MnistDataSetIterator over idx files
    it reads from a temporary DL4J_TPU_DATA_DIR, by EarlyStoppingTrainer
    (at most GATE_EPOCHS epochs), validated on the test set's CSV through
    RecordReaderDataSetIterator(CSVRecordReader) with the native parser.
    Held: validation accuracy >= 0.95; the CSV parsed natively only; then
    calibrate on 4 training batches, quantize(weight_bits=4) and
    accuracy_delta(fp32, q, csv): int4_dot launched 2 (int4 layers) x the
    validation dispatches, no kernel in training; every one of those
    launches bitwise int4_matmul_plain on its own operands; the report's
    counts recomputed on the host from the two nets' outputs; _int4_gate
    passes it (the relative loss budget's verdict is printed) and rejects
    the control (GATE_CONTROL_TAIL). Then int4_dot against its plain version
    and timed at LENET_INT4_SHAPES (kernel_case)."""
    from deeplearning4j_tpu_torch import native
    from deeplearning4j_tpu_torch.datasets import (CSVRecordReader, ImagePreProcessingScaler,
                                                   MnistDataSetIterator,
                                                   RecordReaderDataSetIterator)
    from deeplearning4j_tpu_torch.earlystopping import (EarlyStoppingConfiguration,
                                                        EarlyStoppingTrainer,
                                                        MaxEpochsTerminationCondition,
                                                        ScoreImprovementEpochTerminationCondition)
    from deeplearning4j_tpu_torch.models import LeNet
    from deeplearning4j_tpu_torch.perf.kernels import int4_dot
    from deeplearning4j_tpu_torch.quant import calibrate, quantize
    from deeplearning4j_tpu_torch.quant.gates import accuracy_delta
    from deeplearning4j_tpu_torch.quant.lowering import QuantizedDenseLayer, QuantizedOutputLayer

    t_phase = time.perf_counter()
    root = os.path.join(workdir, "dl4j_data")
    csv_path = os.path.join(workdir, "mnist_test.csv")
    t0 = time.perf_counter()
    _write_mnist_files(root, csv_path)
    write_s = time.perf_counter() - t0
    old = os.environ.get("DL4J_TPU_DATA_DIR")
    os.environ["DL4J_TPU_DATA_DIR"] = root
    try:
        train = MnistDataSetIterator(batch=GATE_BATCH, num_examples=GATE_TRAIN)
    finally:
        if old is None:
            os.environ.pop("DL4J_TPU_DATA_DIR")
        else:
            os.environ["DL4J_TPU_DATA_DIR"] = old
    x0 = train._data[0].features
    if not np.allclose(x0 * 255.0, np.rint(x0 * 255.0), atol=1e-3):
        raise AssertionError("lenet_gates: the iterator did not read the idx files")

    def csv_val():
        it = RecordReaderDataSetIterator(CSVRecordReader(csv_path), GATE_VAL_BATCH,
                                         label_index=0, num_possible_labels=10)
        return it.set_pre_processor(ImagePreProcessingScaler())

    n0, p0 = native.parses_native, native.parses_python
    net = LeNet().init(dev)
    _zero_launch_counts()
    t0 = time.perf_counter()
    result = EarlyStoppingTrainer(
        EarlyStoppingConfiguration([MaxEpochsTerminationCondition(GATE_EPOCHS),
                                    ScoreImprovementEpochTerminationCondition(1)]),
        net, train, csv_val()).fit()
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    if any(_launch_counts().values()):
        raise AssertionError(f"lenet_gates: training launched {_launch_counts()}")
    fp32 = result.best_model
    accuracy = fp32.evaluate(csv_val()).accuracy()
    if accuracy < GATE_ACC:
        raise AssertionError(f"lenet_gates: validation accuracy {accuracy} < {GATE_ACC}")
    calib = [ds.features for _, ds in zip(range(GATE_CALIB_BATCHES), train)]
    q = quantize(fp32, calibrate(fp32, calib), weight_bits=4)
    # the int4 dense and output layers go through int4_dot; int4
    # convolutions run integer-valued float64 products
    int4_layers = sum(isinstance(layer, (QuantizedDenseLayer, QuantizedOutputLayer))
                      and layer.weight_bits == 4 for layer in q.layers)
    kernel = int4_dot.int4_matmul
    calls = []

    def recorded(qq, packed, d):
        out = kernel(qq, packed, d)
        calls.append((qq, packed, d, out))
        return out

    _zero_launch_counts()
    int4_dot.int4_matmul = recorded
    try:
        report = accuracy_delta(fp32, q, csv_val())
    finally:
        int4_dot.int4_matmul = kernel
    launches = int4_dot.launches
    dispatches = -(-GATE_TEST // GATE_VAL_BATCH)
    if launches != int4_layers * dispatches or int4_layers != 2 or len(calls) != launches:
        raise AssertionError(f"lenet_gates: int4_dot launched {launches} ({len(calls)} "
                             f"calls); want {int4_layers} x {dispatches}")
    # each launch of the path against the plain version on its operands
    path_err, path_shapes = 0, set()
    for qq, packed, d, out in calls:
        want = int4_dot.int4_matmul_plain(qq, packed, d)
        path_err = max(path_err, int((out.to(torch.int64) - want.to(torch.int64))
                                     .abs().max().item()))
        path_shapes.add((qq.shape[0], packed.shape[0], d))
    del calls
    if path_err:
        raise AssertionError(f"lenet_gates: int4_dot differs from int4_matmul_plain on the "
                             f"path's operands by up to {path_err}")
    if path_shapes != set(LENET_INT4_SHAPES):
        raise AssertionError(f"lenet_gates: int4_dot ran at {sorted(path_shapes)}; want "
                             f"{LENET_INT4_SHAPES}")
    parses = (native.parses_native - n0, native.parses_python - p0)
    if parses[0] <= 0 or parses[1] != 0:
        raise AssertionError(f"lenet_gates: CSV parses native / python {parses}")
    # the report's counts from the two nets' outputs, on the host
    hits_f = hits_q = agree = n = 0
    nll_f, nll_q = [], []
    for ds in csv_val():
        of, oq = (fp32.output(ds.features).cpu().numpy(),
                  q.output(ds.features).cpu().numpy())
        lab = np.asarray(ds.labels).argmax(-1)
        hits_f += int((of.argmax(-1) == lab).sum())
        hits_q += int((oq.argmax(-1) == lab).sum())
        agree += int((of.argmax(-1) == oq.argmax(-1)).sum())
        n += len(lab)
        nll_f.append(-np.log(np.clip(of[np.arange(len(lab)), lab], 1e-12, None)))
        nll_q.append(-np.log(np.clip(oq[np.arange(len(lab)), lab], 1e-12, None)))
    host = {"examples": n, "fp32_top1": hits_f / n, "quant_top1": hits_q / n,
            "top1_agreement": agree / n}
    if any(report[k] != v for k, v in host.items()):
        raise AssertionError(f"lenet_gates: report {report} vs host {host}")
    for k, v in (("fp32_loss", nll_f), ("quant_loss", nll_q)):
        want = float(np.mean(np.concatenate(v)))
        if abs(report[k] - want) > 1e-6 * abs(want):
            raise AssertionError(f"lenet_gates: {k} {report[k]} vs host {want}")
    loss_delta = _int4_gate(report)

    def tail_dropped(qq, packed, d):
        qq = qq.clone()
        qq[:, -GATE_CONTROL_TAIL:] = 0
        return kernel(qq, packed, d)

    int4_dot.int4_matmul = tail_dropped
    try:
        control = accuracy_delta(fp32, q, csv_val())
    finally:
        int4_dot.int4_matmul = kernel
    try:
        _int4_gate(control)
        control_verdict = None
    except AssertionError as e:
        control_verdict = str(e).split(" (report:")[0]
    if control_verdict is None:
        raise AssertionError(f"lenet_gates: the gate passed the control (the last "
                             f"{GATE_CONTROL_TAIL} inputs of each int4 layer dropped): {control}")
    shape_rows = [kernel_case(torch, dev, flush, b, n, d) for b, n, d in LENET_INT4_SHAPES]
    summary = {"card": card, "train": GATE_TRAIN, "test_csv_rows": GATE_TEST,
               "write_files_s": write_s, "batch": GATE_BATCH,
               "epochs": result.total_epochs, "details": result.termination_details,
               "best_epoch": result.best_model_epoch, "score_vs_epoch": result.score_vs_epoch,
               "train_s": train_s, "steps": net.iteration, "val_accuracy": accuracy,
               "csv_parses_native_python": list(parses), "gate_report": report,
               "gate": "passed: default top-1 budget, agreement floor, |loss delta| "
                       f"<= {GATE_LOSS_ABS}",
               "loss_delta_abs": loss_delta,
               "default_relative_loss_budget_met": report["loss_delta_rel"] <= 0.01,
               "control": {"dropped_inputs": GATE_CONTROL_TAIL, "report": control,
                           "loss_delta_abs": abs(control["quant_loss"] - control["fp32_loss"]),
                           "gate": f"rejected: {control_verdict}"},
               "int4_layers": int4_layers,
               "int4_dot_launches": launches, "validation_dispatches": dispatches,
               "path_launches_bitwise_plain": launches, "path_max_abs_err": path_err,
               "seconds": time.perf_counter() - t_phase}
    print("lenet_gates " + json.dumps(summary), flush=True)
    del net, fp32, q
    torch.cuda.empty_cache()
    return {"int4_dot": launches, "rows": shape_rows}


# ---------------------------------------------------------- training extras
# fused_update: ResNet50 (the training phase's network) in two copies from
# one init, FT_BITWISE steps each on batches drawn on the card, for Adam and
# Nesterovs; then FT_WARM + FT_TIMED timed fit steps a variant
FT_BITWISE, FT_WARM, FT_TIMED = 3, 2, 5
FT_NESTEROVS_LR = 1e-2
# transfer_learning: the Adam network of fused_update frozen up to
# TL_BOUNDARY, res5 and a new TL_CLASSES-way head fine-tuned with Nesterovs
# for TL_STEPS steps over TL_TRAIN batches of synthetic_images (data_tier's
# 10 classes); TL_FEATURIZE batches through TransferLearningHelper
TL_BOUNDARY, TL_CLASSES, TL_STEPS, TL_TRAIN, TL_FEATURIZE = "res4f_out", 10, 10, 2, 4
TL_LR, TL_CKPT_EVERY = 1e-4, 5
TL_TRAINABLE_BLOCKS = 10      # res5's fused blocks: 3 bottlenecks x 3 + its shortcut
# card against CPU: a narrow graph of three fused blocks (two frozen), float32
TL_CHECK_SIDE, TL_CHECK_BATCH, TL_CHECK_STEPS = 32, 4, 3
TL_CHECK_LOSS_RTOL, TL_CHECK_FRAC = 1e-4, 1e-4   # parameters: of each tensor's max |p|
# solvers: LeNet (configs[0]) on SOLVER_N synthetic MNIST images as one batch:
# fit with each algorithm's default Solver, then SOLVER_ITERS iterations of
# Solver(algo) called directly, the backtracking search up to
# SOLVER_LINE_TRIALS trials (step 1 halved down to 2^-19); card against CPU
# on the first len(SOLVER_RTOL) scores for each seed of SOLVER_SEEDS (seeds
# 0-2 until PR 21; seed 0 alone since, to keep the run inside its time: each
# seed's check is the same check on other data, run on the host's CPU)
SOLVER_ALGOS = ("lbfgs", "conjugate_gradient", "line_gradient_descent")
SOLVER_N, SOLVER_ITERS, SOLVER_LINE_TRIALS = 2048, 20, 20
SOLVER_SEEDS = (0,)
# the limit on score i: |card - CPU| / max(|CPU|, SOLVER_FLOOR). The two
# devices sum float32 losses in other orders and the line searches branch
# on them, so the trajectories part a little more at every iteration; the
# limits are 4.3-9.6x the largest sound reading at each index over LeNet's
# seeds 0-3 on an H100 (1.0e-7, 4.4e-7, 4.5e-5, 1.2e-3, 4.5e-3). A score
# below the floor (CG reaches 4e-7) is judged on the floor's scale
SOLVER_RTOL, SOLVER_FLOOR = (1e-6, 2e-6, 2e-4, 5e-3, 2e-2), 1e-4
# the controls: the same card runs with every gradient perturbed by eps of
# its norm; the limits must catch the first, and whether they catch the
# second is printed
SOLVER_CONTROL_EPS, SOLVER_PROBE_EPS = 1e-1, 1e-2
# streaming: LeNet fed STREAM_BATCHES .npz batches of STREAM_BATCH over HTTP
STREAM_BATCHES, STREAM_BATCH = 8, 64


def _same_bits(torch, a, b) -> bool:
    from deeplearning4j_tpu_torch.nn.tree import tree_leaves
    la, lb = tree_leaves(a), tree_leaves(b)
    return len(la) == len(lb) and all(
        torch.equal(x, y) if isinstance(x, torch.Tensor) else x == y for x, y in zip(la, lb))


def _clone_tree(torch, tree):
    from deeplearning4j_tpu_torch.nn.tree import tree_map
    return tree_map(lambda t: t.detach().clone(), tree)


def _device_window(torch, fn) -> dict:
    """Device kernel launches and device ms of ``fn()`` from one
    torch.profiler window (the card synchronized at both ends)."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return {"launches": len(_device_spans(prof)),
            "device_ms": sum(ms for _, ms in _kernel_times(prof))}


def _card_images(torch, dev, n, side, classes, seed):
    """``n`` normal images and one-hot labels drawn on the card."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    x = torch.randn((n, side, side, 3), generator=gen, device=dev)
    y = torch.nn.functional.one_hot(torch.randint(0, classes, (n,), generator=gen, device=dev),
                                    classes).float()
    return x, y


def fused_update_phase(torch, dev, card):
    """The bucketed updater on ResNet50 at full width (the training phase's
    network: 224 x 224 x 3, batch 128, bf16 on float32 masters, fused). Two
    copies from one init take FT_BITWISE steps on the same card batches: one
    through TrainStep._apply_updates (bucketed_apply), the other through
    bucketed_apply(threshold=0), the per-tensor path, with the gradients
    and batch statistics of the first; after every step every parameter,
    every updater slot and every count must be bitwise equal. Adam 1e-3, then
    Nesterovs. One step of each path is profiled for the updater's device
    launches and ms. Then, for Adam, FT_WARM + FT_TIMED fit steps of each
    path (step ms median) and one profiled bucketed step (idle share).
    Returns the trained Adam network, a summary, and the bn launches."""
    import functools

    from deeplearning4j_tpu_torch.datasets import DataSet, MultiDataSet
    from deeplearning4j_tpu_torch.nn import training
    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
    from deeplearning4j_tpu_torch.nn.tree import tree_leaves
    from deeplearning4j_tpu_torch.optimize.fused_update import bucketed_apply, plan_buckets
    from deeplearning4j_tpu_torch.optimize.updaters import Adam, Nesterovs
    from deeplearning4j_tpu_torch.perf.kernels import bn_act

    t_phase = time.perf_counter()
    batches = [DataSet(*_card_images(torch, dev, TRAIN_BATCH, TRAIN_SIDE, 1000, 40 + i))
               for i in range(FT_BITWISE)]
    bn_act.fwd_launches = bn_act.bwd_launches = 0
    summary, keep = {"card": card}, None
    for name, upd in (("adam", Adam(learning_rate=1e-3)),
                      ("nesterovs", Nesterovs(learning_rate=FT_NESTEROVS_LR, momentum=0.9))):
        conf = resnet50_train_conf(upd)
        a = ComputationGraph(conf, dev).init()
        b = ComputationGraph(conf, dev)
        b.set_params(_clone_tree(torch, a.params), _clone_tree(torch, a.state))
        keys = list(a._updaters)
        plan = plan_buckets(keys, a._updaters, a.params)
        leaves = len(tree_leaves(a.params))
        windows, losses = {}, []
        for step, ds in enumerate(batches):
            inputs, labels, fm, lm = a._batch(MultiDataSet.from_dataset(ds))
            loss, grads, new_state = a._loss_and_grads(inputs, labels, a._gen, fm, lm)
            losses.append(float(loss))

            def bucketed(g=grads):
                a._apply_updates(g)

            def per_tensor(g=grads):
                with torch.no_grad():
                    bucketed_apply(keys, b._updaters, b._gnorms, b.params, g, b.opt_state,
                                   threshold=0)

            if step == 1:
                windows = {"bucketed": _device_window(torch, bucketed),
                           "per_tensor": _device_window(torch, per_tensor)}
            else:
                bucketed()
                per_tensor()
            a._commit_state(new_state)
            b._commit_state(new_state)
            torch.cuda.synchronize()
            if not (_same_bits(torch, a.params, b.params)
                    and _same_bits(torch, a.opt_state, b.opt_state)):
                raise AssertionError(f"fused_update {name}: bucketed and per-tensor differ "
                                     f"after step {step}")
        if not all(np.isfinite(losses)):
            raise AssertionError(f"fused_update {name}: losses {losses}")
        entry = {"leaves": leaves, "buckets": [
            {"updater": type(u).__name__, "dtype": key[1], "members": len(m)}
            for key, (u, m) in plan.items()],
            "bitwise_steps": len(batches), "losses": losses,
            "updater_launches": {k: w["launches"] for k, w in windows.items()},
            "updater_device_ms": {k: w["device_ms"] for k, w in windows.items()}}
        if name == "adam":
            ds = batches[0]
            _, times = _timed_steps(torch, a, ds, FT_WARM, FT_TIMED)
            orig = training.bucketed_apply
            training.bucketed_apply = functools.partial(orig, threshold=0)
            try:
                _, pt_times = _timed_steps(torch, b, ds, FT_WARM, FT_TIMED)
            finally:
                training.bucketed_apply = orig
            step_ms = float(np.median(times))
            prof = _profile_step(torch, a, ds, step_ms)
            entry.update({"median_step_ms": step_ms, "step_ms": times,
                          "per_tensor_median_step_ms": float(np.median(pt_times)),
                          "per_tensor_step_ms": pt_times,
                          "device_busy_ms": prof["device_busy_ms"],
                          "idle_share": prof["idle_share"],
                          "optimizer_device_ms_in_profile":
                              prof["device_ms_by_family"]["optimizer"]})
            keep = a
        summary[name] = entry
        del a, b
        torch.cuda.empty_cache()
    launches = {"fwd": bn_act.fwd_launches, "bwd": bn_act.bwd_launches}
    summary.update({"bn_act_launches": launches, "seconds": time.perf_counter() - t_phase})
    print("fused_update " + json.dumps(summary), flush=True)
    return keep, summary, launches


class _SnapshotAt:
    """A listener that keeps copies of the parameters and state as they are
    after step ``iteration``, beside CheckpointListener's save of that step."""

    def __init__(self, torch, iteration):
        self.torch, self.iteration, self.params, self.state = torch, iteration, None, None

    def iteration_done(self, model, iteration, epoch):
        if iteration == self.iteration:
            self.params = _clone_tree(self.torch, model.params)
            self.state = _clone_tree(self.torch, model.state)

    def on_epoch_start(self, model):
        pass

    def on_epoch_end(self, model):
        pass


def _narrow_tl_conf():
    """A narrow graph of the fine-tuning network's shape: three fused
    conv-BN-relu blocks, average pooling, a 4-way head, float32."""
    from deeplearning4j_tpu_torch.models import ResNet50
    from deeplearning4j_tpu_torch.nn.conf.graph import GraphBuilder
    from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
    from deeplearning4j_tpu_torch.nn.conf.layers import OutputLayer
    from deeplearning4j_tpu_torch.nn.conf.network import Builder
    from deeplearning4j_tpu_torch.nn.conf.pooling import GlobalPoolingLayer
    from deeplearning4j_tpu_torch.optimize.updaters import Sgd

    m = ResNet50(num_classes=4, input_shape=(TL_CHECK_SIDE, TL_CHECK_SIDE, 3))
    parent = Builder()
    parent.seed(3).updater(Sgd(learning_rate=0.1)).weight_init("relu")
    g = GraphBuilder(parent)
    g.add_inputs("input")
    x = m._conv_bn(g, "stem", "input", 16, (3, 3))
    x = m._conv_bn(g, "blk1", x, 16, (3, 3))
    x = m._conv_bn(g, "blk2", x, 32, (1, 1))
    g.add_layer("avg_pool", GlobalPoolingLayer(pooling_type="avg"), x)
    g.add_layer("output", OutputLayer(n_out=4, activation="softmax", loss="mcxent"),
                "avg_pool")
    g.set_outputs("output")
    g.set_input_types(InputType.convolutional(TL_CHECK_SIDE, TL_CHECK_SIDE, 3))
    return g.build().fused()


def tl_card_vs_cpu(torch, dev) -> dict:
    """The narrow graph frozen up to blk1 (two fused blocks frozen, one
    trainable, a new 3-way head, Nesterovs): TL_CHECK_STEPS steps on the
    card (3 bn_act_fwd and 1 bn_act_bwd launches a step) and on the CPU
    (plain versions) from the same weights and batches. Loss within
    TL_CHECK_LOSS_RTOL, every parameter and running statistic within
    TL_CHECK_FRAC of its tensor's largest magnitude; frozen parameters
    bitwise unchanged on both."""
    from deeplearning4j_tpu_torch.datasets import DataSet
    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
    from deeplearning4j_tpu_torch.nn.transferlearning import (FineTuneConfiguration,
                                                              TransferLearning)
    from deeplearning4j_tpu_torch.nn.tree import tree_leaves, tree_map
    from deeplearning4j_tpu_torch.optimize.updaters import Nesterovs
    from deeplearning4j_tpu_torch.perf.kernels import bn_act

    base = ComputationGraph(_narrow_tl_conf(), "cpu").init()
    cpu = (TransferLearning.GraphBuilder(base)
           .fine_tune_configuration(FineTuneConfiguration(
               updater=Nesterovs(learning_rate=0.05, momentum=0.9)))
           .set_feature_extractor("blk1_act").n_out_replace("output", 3).build())
    card_net = ComputationGraph(cpu.conf, dev).set_params(
        tree_map(lambda t: t.to(dev, copy=True), cpu.params),
        tree_map(lambda t: t.to(dev, copy=True), cpu.state))
    frozen = sorted(cpu._frozen)
    before = _clone_tree(torch, {n: cpu.params[n] for n in frozen})
    rng = np.random.default_rng(8)
    losses, per_step = [], []
    for _ in range(TL_CHECK_STEPS):
        x = rng.standard_normal((TL_CHECK_BATCH, TL_CHECK_SIDE, TL_CHECK_SIDE, 3)
                                ).astype(np.float32)
        y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, TL_CHECK_BATCH)]
        cpu.fit(DataSet(x, y))
        bn_act.fwd_launches = bn_act.bwd_launches = 0
        card_net.fit(DataSet(torch.from_numpy(x).to(dev), torch.from_numpy(y).to(dev)))
        torch.cuda.synchronize()
        per_step.append([bn_act.fwd_launches, bn_act.bwd_launches])
        losses.append([float(card_net.score()), float(cpu.score())])
    if any(s != [3, 1] for s in per_step):
        raise AssertionError(f"tl_card_vs_cpu: bn launches a step {per_step}, want [3, 1]")
    loss_err = max(abs(a - b) / abs(b) for a, b in losses)
    if loss_err > TL_CHECK_LOSS_RTOL:
        raise AssertionError(f"tl_card_vs_cpu: losses {losses}")
    worst = 0.0
    for tree in ("params", "state"):
        for got, want in zip(tree_leaves(getattr(card_net, tree)),
                             tree_leaves(getattr(cpu, tree))):
            scale = float(want.abs().max()) or 1.0
            worst = max(worst, float((got.cpu() - want).abs().max()) / scale)
    if worst > TL_CHECK_FRAC:
        raise AssertionError(f"tl_card_vs_cpu: a tensor differs by {worst} of its max")
    for n in frozen:
        if not (_same_bits(torch, cpu.params[n], before[n])
                and _same_bits(torch, card_net.params[n],
                               tree_map(lambda t: t.to(dev), before[n]))):
            raise AssertionError(f"tl_card_vs_cpu: frozen vertex {n} moved")
    return {"frozen": frozen, "steps": TL_CHECK_STEPS, "losses_card_cpu": losses,
            "loss_rel_err": loss_err, "max_frac_err": worst,
            "limits": {"loss_rtol": TL_CHECK_LOSS_RTOL, "frac": TL_CHECK_FRAC},
            "bn_launches_per_step": per_step}


def transfer_learning_phase(torch, dev, card, base, full, workdir):
    """Fine-tuning ResNet50 at full width through TransferLearning.GraphBuilder:
    fused_update's Adam network frozen up to res4f_out (43 fused blocks and
    the stem pool on NoOp), res5 and a new 10-way head fine-tuned with
    Nesterovs(1e-4, 0.9) for TL_STEPS steps at batch 128 bf16 over TL_TRAIN
    batches of synthetic_images (224 x 224 x 3, data_tier's 10 classes).
    Held: the loss falls; every frozen vertex's parameters bitwise
    unchanged; every frozen fused block's running statistics moved (frozen
    BN runs in train mode, as in the JAX package); bn_act_fwd 53 and
    bn_act_bwd 10 launches every step. CheckpointListener (every
    TL_CKPT_EVERY iterations) writes a zip that the port's restore reads
    back bitwise equal to the network at that step; PerformanceListener and
    CollectScoresIterationListener ride along. Then
    TransferLearningHelper(graph, res4f_out): featurize TL_FEATURIZE batches
    (eval mode: no bn launch) and fit_featurized on each (10 + 10 bn
    launches a step), the folded-back parameters bitwise the sub-graph's.
    get_memory_report(minibatch=128) on the card: its rows equal a CPU copy's
    report, and it measures the step's peak. Then tl_card_vs_cpu."""
    import dataclasses

    from deeplearning4j_tpu_torch.datasets import DataSet, synthetic_images
    from deeplearning4j_tpu_torch.nn.conf.convolutional import FusedConvBNActivation
    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
    from deeplearning4j_tpu_torch.nn.memory import get_memory_report
    from deeplearning4j_tpu_torch.nn.transferlearning import (FineTuneConfiguration,
                                                              TransferLearning,
                                                              TransferLearningHelper)
    from deeplearning4j_tpu_torch.nn.tree import tree_map
    from deeplearning4j_tpu_torch.optimize.listeners import (CheckpointListener,
                                                             CollectScoresIterationListener,
                                                             PerformanceListener)
    from deeplearning4j_tpu_torch.optimize.updaters import Nesterovs
    from deeplearning4j_tpu_torch.perf.kernels import bn_act
    from deeplearning4j_tpu_torch.utils.serialization import restore

    t_phase = time.perf_counter()
    t0 = time.perf_counter()
    net = (TransferLearning.GraphBuilder(base)
           .fine_tune_configuration(FineTuneConfiguration(
               updater=Nesterovs(learning_rate=TL_LR, momentum=0.9)))
           .set_feature_extractor(TL_BOUNDARY).n_out_replace("output", TL_CLASSES).build())
    build_s = time.perf_counter() - t0
    fused = [n for n, (o, _) in net.vertices.items() if isinstance(o, FusedConvBNActivation)]
    frozen_fused = [n for n in fused if n in net._frozen]
    if len(fused) - len(frozen_fused) != TL_TRAINABLE_BLOCKS:
        raise AssertionError(f"transfer_learning: {len(fused) - len(frozen_fused)} trainable "
                             f"fused blocks, want {TL_TRAINABLE_BLOCKS}")
    frozen_params = {n: _clone_tree(torch, net.params[n]) for n in net._frozen}
    frozen_stats = {n: _clone_tree(torch, net.state[n]) for n in frozen_fused}
    x, y = synthetic_images(TL_FEATURIZE * TRAIN_BATCH, TRAIN_SIDE, 3,
                            num_classes=TL_CLASSES, seed=5)
    batches = [DataSet(torch.from_numpy(x[i * TRAIN_BATCH:(i + 1) * TRAIN_BATCH]).to(dev),
                       torch.from_numpy(y[i * TRAIN_BATCH:(i + 1) * TRAIN_BATCH]).to(dev))
               for i in range(TL_FEATURIZE)]
    del x, y
    ckpt_dir = os.path.join(workdir, "tl_ckpt")
    ckpt = CheckpointListener(ckpt_dir, every_n_iterations=TL_CKPT_EVERY, keep_last=1)
    snap = _SnapshotAt(torch, TL_CKPT_EVERY)
    perf, scores = PerformanceListener(frequency=1), CollectScoresIterationListener()
    net.set_listeners(ckpt, snap, perf, scores)
    times, per_step, rates = [], [], []
    for step in range(TL_STEPS):
        bn_act.fwd_launches = bn_act.bwd_launches = 0
        t0 = time.perf_counter()
        net.fit(batches[step % TL_TRAIN])
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        per_step.append([bn_act.fwd_launches, bn_act.bwd_launches])
        rates.append(perf.samples_per_sec)
    want = [RESNET50_FUSED_BLOCKS, TL_TRAINABLE_BLOCKS]
    if any(s != want for s in per_step):
        raise AssertionError(f"transfer_learning: bn launches a step {per_step}, want {want}")
    losses = [s for _, s in scores.scores]
    if not (all(np.isfinite(losses)) and losses[-1] < losses[0]):
        raise AssertionError(f"transfer_learning: losses {losses}")
    moved_params = [n for n in net._frozen
                    if not _same_bits(torch, net.params[n], frozen_params[n])]
    if moved_params:
        raise AssertionError(f"transfer_learning: frozen vertices moved: {moved_params}")
    still = [n for n in frozen_fused
             if torch.equal(net.state[n]["mean"], frozen_stats[n]["mean"])]
    if still:
        raise AssertionError(f"transfer_learning: frozen BN running stats did not move: "
                             f"{still}")
    del frozen_params, frozen_stats
    # the checkpoint of step TL_CKPT_EVERY, read back
    t0 = time.perf_counter()
    back = restore(CheckpointListener.last_checkpoint(ckpt_dir), device=dev)
    restore_s = time.perf_counter() - t0
    same = [_same_bits(torch, back.params, snap.params),
            _same_bits(torch, back.state, snap.state), back.iteration == TL_CKPT_EVERY]
    if not all(same):
        raise AssertionError(f"transfer_learning: the checkpoint does not read back as the "
                             f"network of its step (params, state, iteration: {same})")
    del back, snap
    step_ms = float(np.median(times))
    net.set_listeners()
    prof = _profile_step(torch, net, batches[0], step_ms)

    # the helper: boundary features in eval mode, the rest fitted on them
    helper = TransferLearningHelper(net, TL_BOUNDARY)
    bn_act.fwd_launches = bn_act.bwd_launches = 0
    t0 = time.perf_counter()
    feats = [helper.featurize(ds.features)[0] for ds in batches]
    torch.cuda.synchronize()
    featurize_ms = (time.perf_counter() - t0) * 1e3 / len(batches)
    if (bn_act.fwd_launches, bn_act.bwd_launches) != (0, 0):
        raise AssertionError(f"transfer_learning: featurize launched bn kernels "
                             f"({bn_act.fwd_launches}, {bn_act.bwd_launches})")
    sub_steps, sub_times, featurized = [], [], {"fwd": 0, "bwd": 0}
    for f, ds in zip(feats, batches):
        bn_act.fwd_launches = bn_act.bwd_launches = 0
        t0 = time.perf_counter()
        sub = helper.fit_featurized(f, ds.labels)
        torch.cuda.synchronize()
        sub_times.append((time.perf_counter() - t0) * 1e3)
        sub_steps.append([bn_act.fwd_launches, bn_act.bwd_launches])
        featurized["fwd"] += bn_act.fwd_launches
        featurized["bwd"] += bn_act.bwd_launches
        folded = [n for n in sub.conf.vertices if n in net.params]
        if not all(_same_bits(torch, net.params[n], sub.params[n]) for n in folded):
            raise AssertionError("transfer_learning: fit_featurized did not fold the "
                                 "sub-graph's parameters back bitwise")
    if any(s != [TL_TRAINABLE_BLOCKS] * 2 for s in sub_steps):
        raise AssertionError(f"transfer_learning: fit_featurized bn launches {sub_steps}")
    sub_losses = sub.score()
    del feats, sub, helper

    # the memory report: measured on the card, rows equal to a CPU copy's
    rep = get_memory_report(net, minibatch=TRAIN_BATCH)
    cpu_net = ComputationGraph(net.conf, "cpu").set_params(
        tree_map(lambda t: t.to("cpu", copy=True), net.params),
        tree_map(lambda t: t.to("cpu", copy=True), net.state))
    cpu_rep = get_memory_report(cpu_net, minibatch=TRAIN_BATCH)
    del cpu_net
    rows = [dataclasses.asdict(r) for r in rep.layers]
    if rows != [dataclasses.asdict(r) for r in cpu_rep.layers] or \
            (rep.total_param_bytes, rep.updater_state_bytes, rep.total_activation_bytes) != \
            (cpu_rep.total_param_bytes, cpu_rep.updater_state_bytes,
             cpu_rep.total_activation_bytes) or cpu_rep.compiled is not None \
            or not rep.compiled or rep.compiled["peak_bytes"] <= 0:
        raise AssertionError("transfer_learning: the card's memory report differs from the "
                             "CPU's")
    check = tl_card_vs_cpu(torch, dev)
    summary = {
        "card": card, "boundary": TL_BOUNDARY, "frozen_vertices": len(net._frozen),
        "frozen_fused_blocks": len(frozen_fused), "trainable_fused_blocks": TL_TRAINABLE_BLOCKS,
        "batch": TRAIN_BATCH, "dtype": "bfloat16", "build_s": build_s,
        "losses": losses, "median_step_ms": step_ms, "step_ms": times,
        "images_per_s": TRAIN_BATCH / (step_ms / 1e3),
        "performance_listener_samples_per_s": rates,
        "device_busy_ms": prof["device_busy_ms"], "idle_share": prof["idle_share"],
        "device_ms_by_family": prof["device_ms_by_family"],
        "full_network_median_step_ms": full["adam"]["median_step_ms"],
        "full_network_idle_share": full["adam"]["idle_share"],
        "bn_launches_per_step": per_step[0], "checkpoint_restore_s": restore_s,
        "featurize_ms_per_batch": featurize_ms, "fit_featurized_step_ms": sub_times,
        "fit_featurized_bn_launches_per_step": sub_steps[0],
        "fit_featurized_last_loss": sub_losses,
        "memory_report": {"rows": len(rows), "total_param_bytes": rep.total_param_bytes,
                          "updater_state_bytes": rep.updater_state_bytes,
                          "activation_bytes": rep.total_activation_bytes,
                          "measured": rep.compiled},
        "card_vs_cpu": check, "seconds": time.perf_counter() - t_phase}
    print("transfer_learning " + json.dumps(summary), flush=True)
    launches = {"fwd": sum(s[0] for s in per_step), "bwd": sum(s[1] for s in per_step)}
    del net, batches
    torch.cuda.empty_cache()
    return launches, featurized


def _perturbed_solver(torch, base, eps):
    """``base``'s Solver class with every gradient it takes perturbed by
    ``eps`` of its norm along one fixed random unit vector: the control that
    a card-against-CPU limit on the scores must catch."""

    class Perturbed(base):
        def _flat_fns(self, net, ds):
            w0, unravel, value_fn, value_and_grad = base._flat_fns(net, ds)
            gen = torch.Generator(device=w0.device)
            gen.manual_seed(1)
            r = torch.randn(w0.shape, generator=gen, device=w0.device)
            r /= torch.linalg.vector_norm(r)

            def perturbed(w):
                v, g = value_and_grad(w)
                return v, g + eps * torch.linalg.vector_norm(g) * r

            return w0, unravel, value_fn, perturbed

    return Perturbed


def _score_errs(got, want):
    """|got_i - want_i| / max(|want_i|, SOLVER_FLOOR), each over its limit
    SOLVER_RTOL[i], for the first len(SOLVER_RTOL) scores: (errors,
    largest error over its limit)."""
    errs = [abs(a - b) / max(abs(b), SOLVER_FLOOR) for a, b in zip(got, want)][:len(SOLVER_RTOL)]
    return errs, max(e / lim for e, lim in zip(errs, SOLVER_RTOL))


def solvers_phase(torch, dev, card) -> dict:
    """The full-batch solvers on LeNet (configs[0]) with SOLVER_N synthetic
    MNIST images as one batch, for lbfgs, conjugate_gradient and
    line_gradient_descent:

    - fit, as a user calls it: Solver(optimization_algo) with its defaults
      (100 iterations, the backtracking search's 5 trials); the score
      finite, no kernel of the port launched, and for lbfgs lower than
      before (the 5-trial search of the other two gives up within a few
      iterations on LeNet; how far each got is printed);
    - Solver(algo, SOLVER_ITERS, BackTrackLineSearch(SOLVER_LINE_TRIALS))
      called directly: every score finite, the last below the first, ms an
      iteration printed;
    - card against CPU, for each seed of SOLVER_SEEDS (LeNet's seed and the
      data's): len(SOLVER_RTOL) iterations of that solver on both, score i
      within SOLVER_RTOL[i] of the CPU's, relative to the CPU score itself
      (SOLVER_FLOOR below); the control, the same card run with every
      gradient perturbed by SOLVER_CONTROL_EPS of its norm, must exceed a
      limit, and whether the probe at SOLVER_PROBE_EPS does is printed."""
    import dataclasses

    from deeplearning4j_tpu_torch.datasets import DataSet, synthetic_mnist
    from deeplearning4j_tpu_torch.models import LeNet
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu_torch.nn.tree import tree_map
    from deeplearning4j_tpu_torch.optimize.solvers import BackTrackLineSearch, Solver

    t_phase = time.perf_counter()
    controls = {"control": _perturbed_solver(torch, Solver, SOLVER_CONTROL_EPS),
                "probe": _perturbed_solver(torch, Solver, SOLVER_PROBE_EPS)}
    check_iters = len(SOLVER_RTOL)

    def lenet(algo, seed):
        conf = dataclasses.replace(LeNet(seed=12345 + seed).conf(), optimization_algo=algo)
        return MultiLayerNetwork(conf, dev).init()

    def copy_to(net, device):
        return MultiLayerNetwork(net.conf, device).set_params(
            tree_map(lambda t: t.to(device, copy=True), net.params),
            tree_map(lambda t: t.to(device, copy=True), net.state))

    def run(cls, net, ds, iters):
        solver = cls(net.conf.optimization_algo, max_iterations=iters,
                     line_search=BackTrackLineSearch(max_iterations=SOLVER_LINE_TRIALS))
        t0 = time.perf_counter()
        solver.optimize(net, ds)
        torch.cuda.synchronize()
        return solver.score_history, time.perf_counter() - t0

    data = {seed: synthetic_mnist(SOLVER_N, seed=seed) for seed in SOLVER_SEEDS}
    card_ds = {seed: DataSet(*(torch.from_numpy(a).to(dev) for a in xy))
               for seed, xy in data.items()}
    seed0 = SOLVER_SEEDS[0]
    rows = {}
    for algo in SOLVER_ALGOS:
        net = lenet(algo, seed0)
        before = net.score_dataset(card_ds[seed0])
        _zero_launch_counts()
        t0 = time.perf_counter()
        net.fit(card_ds[seed0])
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
        after = net.score()
        if any(_launch_counts().values()):
            raise AssertionError(f"solvers: {algo} fit launched a kernel of the port")
        if not np.isfinite(after) or net.iteration != 1 or (algo == "lbfgs" and after >= before):
            raise AssertionError(f"solvers: {algo} fit from {before} to {after}")
        row = {"fit_default": {"score_before": before, "score_after": after, "fit_s": fit_s}}
        hist, secs = run(Solver, lenet(algo, seed0), card_ds[seed0], SOLVER_ITERS)
        if not (all(np.isfinite(hist)) and hist[-1] < hist[0]):
            raise AssertionError(f"solvers: {algo} scores {hist}")
        row.update({"iterations": len(hist), "scores": hist, "seconds": secs,
                    "ms_per_iteration": secs * 1e3 / len(hist)})
        checks = {}
        for seed in SOLVER_SEEDS:
            card_net = lenet(algo, seed)
            nets = {"card": card_net, "cpu": copy_to(card_net, "cpu"),
                    **{k: copy_to(card_net, dev) for k in controls}}
            ref, _ = run(Solver, nets["cpu"], DataSet(*data[seed]), check_iters)
            entry = {"cpu_scores": ref}
            for k, cls in (("card", Solver), *controls.items()):
                got, _ = run(cls, nets[k], card_ds[seed], check_iters)
                errs, over = _score_errs(got, ref)
                entry[k] = {"scores": got, "errs": errs, "max_over_limit": over}
            checks[seed] = entry
            if len(ref) < check_iters or entry["card"]["max_over_limit"] > 1:
                raise AssertionError(f"solvers: {algo} seed {seed} card {entry['card']} "
                                     f"vs CPU {ref}")
            if entry["control"]["max_over_limit"] <= 1:
                raise AssertionError(f"solvers: {algo} seed {seed}: the control "
                                     f"{entry['control']} stays within the limits of {ref}")
        row["card_vs_cpu"] = checks
        for k in ("card", *controls):
            row[f"{k}_max_over_limit"] = [checks[sd][k]["max_over_limit"] for sd in SOLVER_SEEDS]
        rows[algo] = row
    summary = {"card": card, "examples": SOLVER_N, "seeds": list(SOLVER_SEEDS),
               "limits": list(SOLVER_RTOL), "floor": SOLVER_FLOOR,
               "control_eps": SOLVER_CONTROL_EPS, "probe_eps": SOLVER_PROBE_EPS, **rows,
               "seconds": time.perf_counter() - t_phase}
    print("solvers " + json.dumps(summary), flush=True)
    return summary


def streaming_phase(torch, dev, card) -> dict:
    """A StreamingHttpReceiver on a free loopback port takes STREAM_BATCHES
    .npz batches (synthetic MNIST, STREAM_BATCH rows) POSTed by a client
    thread, then /end, while LeNet's fit(prefetch=True) consumes the
    StreamingDataSetIterator on the card. Every POST answers 200, every
    batch is consumed once, one step a batch, the losses finite."""
    import io
    import urllib.request

    from deeplearning4j_tpu_torch.datasets import (StreamingDataSetIterator,
                                                   StreamingHttpReceiver, synthetic_mnist)
    from deeplearning4j_tpu_torch.models import LeNet

    it = StreamingDataSetIterator(queue_size=4, poll_timeout=120)
    rx = StreamingHttpReceiver(it, port=0)
    x, y = synthetic_mnist(STREAM_BATCHES * STREAM_BATCH, seed=3)
    codes = []

    def post(path, body):
        req = urllib.request.Request(f"http://127.0.0.1:{rx.port}{path}", data=body,
                                     method="POST")
        with urllib.request.urlopen(req, timeout=120) as r:
            codes.append(r.status)

    def produce():
        for i in range(STREAM_BATCHES):
            buf = io.BytesIO()
            sl = slice(i * STREAM_BATCH, (i + 1) * STREAM_BATCH)
            np.savez(buf, features=x[sl], labels=y[sl])
            post("/push", buf.getvalue())
        post("/end", b"")

    net = LeNet().init(dev)
    producer = threading.Thread(target=produce)
    try:
        t0 = time.perf_counter()
        producer.start()
        net.fit(it, prefetch=True)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        producer.join(timeout=120)
    finally:
        rx.stop()
    if codes != [200] * (STREAM_BATCHES + 1) or it.consumed != STREAM_BATCHES \
            or net.iteration != STREAM_BATCHES or not np.isfinite(net.score()):
        raise AssertionError(f"streaming: statuses {codes}, consumed {it.consumed}, "
                             f"steps {net.iteration}")
    summary = {"card": card, "batches_pushed": it.pushed, "batches_consumed": it.consumed,
               "batch": STREAM_BATCH, "wall_s": wall, "steps": net.iteration,
               "last_loss": net.score()}
    print("streaming " + json.dumps(summary), flush=True)
    return summary


#: seconds each phase of main() took, by the phase function's name
# ------------------------------------------------- slice 17: checkpoint tier
# perf_tier: the memory planner, the autotuner and the TuningRecord's path on
# the training phase's ResNet50 (bf16, 224 x 224, full width). The planner's
# budget is the fixed bytes + the midpoint of the all-remat and the fused
# saved sets at PT_BATCH rows: it forces remat and stays feasible. The
# allocator's bytes held after one training forward over the saved-set
# measure must lie in PT_RATIO_BAND for the unplanned and the planned
# network: every tensor the backward keeps is made in that forward (in bf16
# the parameters it keeps are the forward's casts; the float32 input is
# not kept, its cast is), and the allocator holds nothing else but the loss
# and 512-byte rounding; only the labels (0.5 MB) were allocated before it.
# The autotuner searches PT_AUTOTUNE_BATCHES x fusion and times PT_TOP_K
# candidates, best of PT_REPS; the served network answers PT_SERVE_ROWS[0],
# PT_SERVE_ROWS[1] and batch_size - 5 rows; trace_check watches
# PT_TRACE_STEPS fit steps
PT_BATCH, PT_RATIO_BAND = 128, (0.85, 1.15)
PT_AUTOTUNE_BATCHES, PT_TOP_K, PT_REPS = (32, 64, 128), 2, 2
PT_SERVE_ROWS, PT_TRACE_STEPS = (3, 20), 3


def resnet50_unfused_conf():
    """The training phase's ResNet50 before fusion (bf16 on float32 masters,
    the zoo's updater)."""
    import dataclasses

    from deeplearning4j_tpu_torch.models import ResNet50

    conf = ResNet50(num_classes=1000, input_shape=(TRAIN_SIDE, TRAIN_SIDE, 3)).conf()
    return dataclasses.replace(conf, dtype="bfloat16")


def _forward_held_bytes(torch, dev, net, x, y) -> int:
    """Bytes the caching allocator holds after one training forward of
    ``net`` on (x, y) with its graph kept, less what it held before."""
    from deeplearning4j_tpu_torch.nn.tree import tree_map
    leaves = tree_map(lambda v: v.detach().requires_grad_(True), net.params)
    torch.cuda.synchronize(dev)
    base = torch.cuda.memory_allocated(dev)
    loss = net._loss_fn(leaves, net.state, [x], [y], net._gen, None, None)[0]
    torch.cuda.synchronize(dev)
    held = torch.cuda.memory_allocated(dev) - base
    del loss, leaves
    torch.cuda.empty_cache()
    return int(held)


def perf_tier_phase(torch, dev, card, workdir) -> dict:
    """The performance tier on ResNet50 bf16 224^2 at full width:

    - plan: ``training_activation_bytes`` at PT_BATCH rows unfused, fused and
      fused with every rematable layer rematted (meta device); ``plan_memory``
      of the unfused configuration under the fixed bytes + the midpoint of
      the last two (fuses, then remats the largest layers); the planned and
      the unplanned (fused) networks built on the card, each one's
      allocator bytes after one training forward against its saved-set
      measure, both ratios in PT_RATIO_BAND, the planned one below the
      unplanned one;
    - launch counts: two ``fit`` steps of the planned network, each
      ``bn_act_fwd`` 53 + the rematted fused blocks (their recompute) and
      ``bn_act_bwd`` 53;
    - autotune over PT_AUTOTUNE_BATCHES x fusion on the card: every
      candidate's meta-device estimate, the confirmed step seconds, the
      winner and its baseline;
    - the record through ``build_network`` -> ``write_model`` -> ``restore``,
      its dict equal after the round trip;
    - serving: ``ParallelInference`` over the restored network inherits the
      record, warms its ladder, answers three batches of other row counts
      (finite, (rows, 1000), within 1e-3 of the network's own output), all
      dispatched at warmed sizes: the model's compile_watch counts one
      compile a bucket and none after;
    - ``trace_check`` around PT_TRACE_STEPS fit steps of the planned network.

    Returns the bn launches of the phase."""
    from deeplearning4j_tpu_torch.analysis import trace_check
    from deeplearning4j_tpu_torch.datasets import DataSet
    from deeplearning4j_tpu_torch.nn.conf.convolutional import FusedConvBNActivation
    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
    from deeplearning4j_tpu_torch.nn.memory import conf_memory_report
    from deeplearning4j_tpu_torch.parallel import ParallelInference
    from deeplearning4j_tpu_torch.perf import autotune as at
    from deeplearning4j_tpu_torch.perf.fusion import fuse, training_activation_bytes
    from deeplearning4j_tpu_torch.perf.kernels import bn_act
    from deeplearning4j_tpu_torch.perf.planner import (_layer_entries, _rematable,
                                                       _with_remat, plan_memory)
    from deeplearning4j_tpu_torch.utils.serialization import restore, write_model

    t_phase = time.perf_counter()
    bn_act.fwd_launches = bn_act.bwd_launches = 0
    conf = resnet50_unfused_conf()
    fused = fuse(conf)
    rematable = {idx: "nothing_saveable" for _k, layer, idx in _layer_entries(fused)
                 if _rematable(layer)}
    t0 = time.perf_counter()
    saved = {"unfused": training_activation_bytes(conf, PT_BATCH),
             "fused": training_activation_bytes(fused, PT_BATCH),
             "all_remat": training_activation_bytes(_with_remat(fused, rematable), PT_BATCH)}
    measure_s = time.perf_counter() - t0
    rep = conf_memory_report(conf, minibatch=PT_BATCH, training_bytes=False)
    fixed = rep.total_param_bytes + rep.updater_state_bytes
    budget = fixed + (saved["all_remat"] + saved["fused"]) // 2
    plan = plan_memory(conf, budget, minibatch=PT_BATCH)
    remat_fused = sum(1 for name in plan.remat
                      if isinstance(plan.conf.vertices[name][0], FusedConvBNActivation))
    if not (plan.fused and plan.remat and plan.fits()
            and plan.measured_activation_bytes < saved["fused"]):
        raise AssertionError(f"perf_tier: plan {plan.summary()}")
    x, y = _card_images(torch, dev, PT_BATCH, TRAIN_SIDE, 1000, 60)
    held = {}
    nets = {"unplanned": ComputationGraph(fused, dev).init(),
            "planned": ComputationGraph(plan.conf, dev).init()}
    for name, net in nets.items():
        held[name] = _forward_held_bytes(torch, dev, net, x, y)
    measured = {"unplanned": saved["fused"], "planned": plan.measured_activation_bytes}
    ratios = {k: held[k] / measured[k] for k in held}
    if not (held["planned"] < held["unplanned"]
            and all(PT_RATIO_BAND[0] <= r <= PT_RATIO_BAND[1] for r in ratios.values())):
        raise AssertionError(f"perf_tier: allocator bytes {held} against the saved sets "
                             f"{measured} (ratios {ratios}, band {PT_RATIO_BAND})")
    del nets["unplanned"]
    torch.cuda.empty_cache()

    # two fit steps of the planned network, launches counted a step
    net = nets.pop("planned")
    ds = DataSet(x, y)
    steps = []
    for _ in range(2):
        f0, b0 = bn_act.fwd_launches, bn_act.bwd_launches
        net.fit(ds)
        torch.cuda.synchronize(dev)
        steps.append({"bn_act_fwd": bn_act.fwd_launches - f0,
                      "bn_act_bwd": bn_act.bwd_launches - b0})
    want = {"bn_act_fwd": RESNET50_FUSED_BLOCKS + remat_fused,
            "bn_act_bwd": RESNET50_FUSED_BLOCKS}
    if any(s != want for s in steps) or not np.isfinite(net.score()):
        raise AssertionError(f"perf_tier: planned steps launched {steps}, want {want} "
                             f"(score {net.score()})")

    # trace_check around PT_TRACE_STEPS steps of the planned network
    with trace_check(model=net) as report:
        for _ in range(PT_TRACE_STEPS):
            net.fit(ds)
    torch.cuda.synchronize(dev)
    syncs = report.sync_points
    trace = {**report.counts(), "first_sync": None if not syncs else syncs[0].where,
             "sync_sites": [f"{h.where} {h.detail.split(' on ')[0][-22:]} x{h.count}"
                            for h in syncs],
             "recompile_keys": [h.where for h in report.recompiles],
             "captured": [h.where for h in report.captured_constants]}
    del net, ds
    torch.cuda.empty_cache()

    # autotune on the card
    t0 = time.perf_counter()
    rec = at.autotune(conf, batch_sizes=PT_AUTOTUNE_BATCHES, fusion="auto", top_k=PT_TOP_K,
                      reps=PT_REPS, device=dev)
    autotune_s = time.perf_counter() - t0
    search = at.autotune.last_search
    confirmed = [c for c in search if c["step_seconds"] is not None]
    if len(confirmed) != PT_TOP_K or rec.batch_size not in PT_AUTOTUNE_BATCHES:
        raise AssertionError(f"perf_tier: autotune searched {search} -> {rec.to_dict()}")

    # the record through a zip
    tuned = at.build_network(conf, rec, device=dev).init()
    path = os.path.join(workdir, "tuned.zip")
    write_model(tuned, path)
    restored = restore(path, device=dev)
    if restored._tuning_record is None or restored._tuning_record.to_dict() != rec.to_dict():
        raise AssertionError("perf_tier: the restored record differs from the written one")
    del tuned

    # serving with the recorded ladder warmed
    pi = ParallelInference(restored, inference_mode="sequential", device=dev)
    try:
        warmed = pi.stats()["warmed_buckets"]
        rows = list(PT_SERVE_ROWS) + [rec.batch_size - 5]
        errs = []
        for r in rows:
            got = pi.output(x[:r].cpu().numpy())
            want_out = restored.output(torch.nn.functional.pad(
                x[:r], (0, 0, 0, 0, 0, 0, 0, pi.bucket_policy.bucket(r) - r)))[0][:r]
            if got.shape != (r, 1000) or not np.isfinite(got).all():
                raise AssertionError(f"perf_tier: served {got.shape} for {r} rows")
            errs.append(float(np.abs(got.astype(np.float64) - want_out).max()))
        st = pi.stats()
    finally:
        pi.shutdown()
    cw = restored.compile_watch
    serving = {"buckets": list(rec.buckets), "warmed": warmed, "rows": rows,
               "max_abs_err": max(errs), "dispatches": cw.dispatches("output"),
               "compiles": cw.compiles("output"), "unwarmed": st["unwarmed_dispatches"],
               "tuning": st["tuning"]}
    if (warmed != sorted(rec.buckets) or st["unwarmed_dispatches"] != 0
            or cw.compiles("output") != len(rec.buckets) or max(errs) > 1e-3
            or not st["tuning"]["applied"]):
        raise AssertionError(f"perf_tier: serving {serving}")
    del restored, pi
    torch.cuda.empty_cache()

    launches = {"fwd": bn_act.fwd_launches, "bwd": bn_act.bwd_launches}
    summary = {
        "card": card, "batch": PT_BATCH, "saved_bytes": saved, "measure_s": measure_s,
        "fixed_bytes": fixed, "budget_bytes": budget,
        "plan": {"fused": plan.fused, "remat_layers": len(plan.remat),
                 "remat_fused_blocks": remat_fused,
                 "predicted_bytes": plan.predicted_activation_bytes,
                 "measured_bytes": plan.measured_activation_bytes,
                 "candidates": plan.candidates_evaluated, "search_s": plan.search_seconds},
        "allocator_bytes": held, "ratio_to_saved": ratios, "ratio_band": list(PT_RATIO_BAND),
        "fit_steps": steps, "want_per_step": want,
        "autotune": {"seconds": autotune_s, "candidates": search,
                     "winner": {k: rec.to_dict()[k] for k in ("batch_size", "fusion", "remat",
                                                              "buckets", "objective",
                                                              "baseline")}},
        "record_round_trip": True, "serving": serving, "trace_check": trace,
        "bn_act_launches": launches, "seconds": time.perf_counter() - t_phase}
    print("perf_tier " + json.dumps(summary), flush=True)
    return launches


# cloud_checkpoint: the disk cache's budget (above a ResNet50 + Adam
# checkpoint of about 300 MB, so whole checkpoints stay cached), the 503
# burst on the first multipart part (its Retry-After seconds), and the
# loopback transfer timed for put / get MB/s
CLOUD_CACHE_BYTES = 2 << 30
CLOUD_PART_BURST, CLOUD_RETRY_AFTER_S = 3, 0.05
# supervised: each attempt's and the whole run's deadline, in seconds
SUPERVISED_ATTEMPT_S, SUPERVISED_OVERALL_S = 300, 600


def _cloud_counters(emu, store) -> dict:
    """The emulator's, the wire client's, the retry layer's and the disk
    cache's counters of one backend_from_url stack."""
    retry, cloud = store.inner, store.inner.inner
    return {"emulator": {k: getattr(emu, k) for k in (
                "faults_injected", "parts_received", "completes", "aborts",
                "pages_served", "auth_rejections")} | {"calls": dict(emu.calls)},
            "client": {"requests_sent": cloud.requests_sent,
                       "multipart_puts": cloud.multipart_puts,
                       "multipart_aborts": cloud.multipart_aborts,
                       "ops": dict(cloud.op_counts)},
            "retry": {k: getattr(retry, k, None) for k in ("retries", "retry_after_honored")},
            "cache": store.stats()}


def cloud_checkpoint_phase(torch, dev, card, workdir, ckpt) -> dict:
    """The checkpoint phase's crash -> restore -> resume (ResNet50 bf16, Adam,
    5 batches of 128, 2 epochs, cudnn.deterministic) with every checkpoint
    going through backend_from_url(<port ObjectStoreEmulator>/ckpt,
    cache_dir=, cache_bytes=): a CachedBackend over RetryingBackend over
    CloudObjectBackend, over loopback HTTP. Scripted faults: a burst of 503s
    with Retry-After on the first multipart part and a 500 on the first
    complete (each torn upload aborted, never listed), a mid-transfer
    disconnect on the restore's get, and rot in transit on the newest
    checkpoint's get (restore_latest falls back one generation). Held: the
    resumed run ends bitwise equal to the checkpoint phase's uninterrupted
    run; no upload left in flight and only committed objects listed; a
    second restore through the same cache hits it; a sharded save of the
    resumed network (CheckpointManager(sharded=True) over the same stack)
    restores bitwise, and a simulated 4-shard set of it restores into one
    network bitwise (N -> M), state_sha equal before and after. Prints bytes
    a checkpoint, put and get MB/s over loopback, the stack's counters."""
    from deeplearning4j_tpu_torch.checkpoint import (CheckpointManager, FaultInjector,
                                                     ObjectStoreEmulator, SimulatedCrash,
                                                     backend_from_url)
    from deeplearning4j_tpu_torch.checkpoint import sharded as shd
    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
    from deeplearning4j_tpu_torch.perf.kernels import bn_act

    t_phase = time.perf_counter()
    conf = resnet50_train_conf()
    batches = ckpt_batches(torch, dev)
    ref = ckpt["record"]
    steps = 0
    caches = iter(os.path.join(workdir, f"cache{i}") for i in range(8))

    def stack(url):
        return backend_from_url(url, cache_dir=next(caches), cache_bytes=CLOUD_CACHE_BYTES)

    def fit(net, cm):
        nonlocal steps
        i0 = net.iteration
        try:
            net.fit(batches, num_epochs=CKPT_EPOCHS, checkpoint_manager=cm)
        except SimulatedCrash:
            steps += net.iteration - i0 + 1
            raise
        steps += net.iteration - i0
        return net

    flags = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    emu = ObjectStoreEmulator().start()
    bn_act.fwd_launches = bn_act.bwd_launches = 0
    try:
        url = emu.bucket_url("ckpt")
        writer = stack(url)
        emu.script("status", CLOUD_PART_BURST, op="part", code=503,
                   retry_after=CLOUD_RETRY_AFTER_S)
        emu.script("status", 1, op="complete", code=500)
        cm = CheckpointManager(storage=writer, save_every_n_steps=CKPT_EVERY, device=dev)
        net = ComputationGraph(conf, dev).init().set_listeners(FaultInjector(kill_at_step=CKPT_KILL))
        try:
            fit(net, cm)
            raise AssertionError("cloud_checkpoint: the injected crash did not fire")
        except SimulatedCrash:
            pass
        cm.close()
        del net
        torch.cuda.empty_cache()
        crashed = _cloud_counters(emu, writer)
        if crashed["client"]["multipart_aborts"] != CLOUD_PART_BURST + 1:
            raise AssertionError(f"cloud_checkpoint: {crashed['client']['multipart_aborts']} "
                                 f"multipart aborts, want {CLOUD_PART_BURST + 1}")
        if emu.in_flight_uploads():
            raise AssertionError(f"cloud_checkpoint: uploads left in flight: "
                                 f"{emu.in_flight_uploads()}")
        listed = writer.list()
        saved = [e["file"] for e in cm.checkpoints()]
        if listed != sorted(saved + ["manifest.json"]):
            raise AssertionError(f"cloud_checkpoint: the bucket lists {listed}, "
                                 f"the journal {saved}")
        # a fresh reader (its own cache): the restore's first get is cut
        # mid-transfer and retried
        reader = stack(url)
        faults = emu.faults_injected
        emu.script("disconnect", 1, op="get", match="ckpt-")
        cm2 = CheckpointManager(storage=reader, save_every_n_steps=CKPT_EVERY, device=dev)
        t0 = time.perf_counter()
        resumed = cm2.restore_latest()
        restore_s = time.perf_counter() - t0
        rs = resumed._resume_state
        if (rs.step, rs.epoch, rs.batch_in_epoch) != CKPT_RESTORED:
            raise AssertionError(f"cloud_checkpoint: restore_latest came back at "
                                 f"{(rs.step, rs.epoch, rs.batch_in_epoch)}")
        if emu.faults_injected != faults + 1 or reader.inner.retries < 1:
            raise AssertionError("cloud_checkpoint: the disconnect was not injected and retried")
        fit(resumed, cm2)
        cm2.close()
        diff = _differences(ref, _run_record(resumed))
        if diff:
            raise AssertionError(f"cloud_checkpoint: the resumed run differs from the "
                                 f"uninterrupted one in {len(diff)} arrays: {diff[:12]}")
        fwd, bwd = bn_act.fwd_launches, bn_act.bwd_launches
        # a second restore through the same cache: served from the disk
        hits = reader.stats()["hits"]
        second = CheckpointManager(storage=reader, device=dev).restore_latest()
        second_hits = reader.stats()["hits"] - hits
        if second_hits < 1 or second._resume_state.step != CKPT_RESTORED[0] + CKPT_EVERY:
            raise AssertionError(f"cloud_checkpoint: the second restore hit the cache "
                                 f"{second_hits} times at step {second._resume_state.step}")
        del second
        # rot in transit on the newest checkpoint: a cold reader falls back
        newest = CheckpointManager(storage=reader, device=dev).checkpoints()[-1]
        emu.script("bitrot", 1, op="get", match=newest["file"])
        back = CheckpointManager(storage=stack(url), device=dev).restore_latest()
        fallback = (newest["step"], back._resume_state.step)
        del back
        torch.cuda.empty_cache()
        if fallback != (CKPT_RESTORED[0] + CKPT_EVERY, CKPT_RESTORED[0]):
            raise AssertionError(f"cloud_checkpoint: rotted step {fallback[0]} fell back to "
                                 f"{fallback[1]}")
        # loopback rates of one checkpoint's bytes through the bare client
        cloud = reader.inner.inner
        data = cloud.get(newest["file"])
        t0 = time.perf_counter()
        cloud.put("rate-probe.bin", data)
        put_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        if cloud.get("rate-probe.bin") != data:
            raise AssertionError("cloud_checkpoint: the probe object came back changed")
        get_s = time.perf_counter() - t0
        cloud.delete("rate-probe.bin")
        # sharded: the resumed network as a shard set over the same stack
        sharded_store = stack(emu.bucket_url("sharded"))
        cms = CheckpointManager(storage=sharded_store, sharded=True, device=dev)
        sha = shd.state_sha(resumed)
        t0 = time.perf_counter()
        name = cms.save(resumed)
        sharded_save_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        back = cms.restore_latest()
        sharded_restore_s = time.perf_counter() - t0
        diff = _differences(ref, _run_record(back))
        if diff or shd.state_sha(back) != sha or not name.endswith(".sharded"):
            raise AssertionError(f"cloud_checkpoint: the sharded restore differs in "
                                 f"{len(diff)} arrays: {diff[:6]}")
        del back
        payloads = [shd.shard_zip_bytes(s, {"batch_in_epoch": 0})
                    for s in shd.simulated_shard_snapshots(resumed, 4)]
        t0 = time.perf_counter()
        merged, meta = shd.restore_from_payloads(payloads, device=dev)
        four_to_one_s = time.perf_counter() - t0
        diff = _differences(ref, _run_record(merged))
        if diff or meta["num_hosts"] != 4 or shd.state_sha(merged) != sha:
            raise AssertionError(f"cloud_checkpoint: the 4 -> 1 restore differs in "
                                 f"{len(diff)} arrays: {diff[:6]}")
        del merged, resumed
        counters = _cloud_counters(emu, reader)
    finally:
        emu.stop()
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = flags
        torch.cuda.empty_cache()
    if not fwd == bwd == RESNET50_FUSED_BLOCKS * steps:
        raise AssertionError(f"cloud_checkpoint: bn_act launched {fwd} forward / {bwd} "
                             f"backward in {steps} steps")
    mb = len(data) / 1e6
    summary = {"card": card, "store": "backend_from_url(emulator, cache_dir, cache_bytes="
                                      f"{CLOUD_CACHE_BYTES})",
               "resume": "bitwise", "restored": list(CKPT_RESTORED),
               "checkpoint_bytes": len(data), "checkpoints": saved,
               "restore_latest_s": restore_s, "second_restore_cache_hits": second_hits,
               "rotted_newest_fell_back": list(fallback),
               "put_MB_per_s": mb / put_s, "get_MB_per_s": mb / get_s,
               "put_s": put_s, "get_s": get_s,
               "sharded": {"file": name, "save_s": sharded_save_s,
                           "restore_s": sharded_restore_s, "restore": "bitwise",
                           "four_to_one": "bitwise", "four_to_one_s": four_to_one_s,
                           "shard_bytes": [len(p) for p in payloads], "state_sha": sha},
               "writer_counters": crashed, "reader_counters": counters,
               "steps": steps, "bn_act_fwd_launches": fwd, "bn_act_bwd_launches": bwd,
               "seconds": time.perf_counter() - t_phase}
    print("cloud_checkpoint " + json.dumps(summary), flush=True)
    return {"fwd": fwd, "bwd": bwd}


SUPERVISED_WORKER = r'''
import json, os, sys, time
sys.path.insert(0, {root!r})
import torch
import chip_smoke as cs
from deeplearning4j_tpu_torch.checkpoint import CheckpointManager, FaultInjector
from deeplearning4j_tpu_torch.checkpoint.sharded import state_sha
from deeplearning4j_tpu_torch.device import resolve_device
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
from deeplearning4j_tpu_torch.optimize.listeners import TrainingListener
from deeplearning4j_tpu_torch.perf.kernels import bn_act

spawned, attempt = float(sys.argv[1]), int(sys.argv[2])
out = os.path.join({workdir!r}, f"attempt{{attempt}}.json")
report = {{"attempt": attempt, "pid": os.getpid(), "import_s": time.time() - spawned}}


class Report(TrainingListener):
    """The report on disk after every step, ahead of the FaultInjector: the
    killed attempt's launches are kept up to its last step."""
    def iteration_done(self, model, iteration, epoch):
        if "first_step_s" not in report:
            torch.cuda.synchronize()
            report["first_step_s"] = time.time() - spawned
            report["first_step"] = iteration
        report.update(steps_done=report.get("steps_done", 0) + 1,
                      bn_act_fwd=bn_act.fwd_launches, bn_act_bwd=bn_act.bwd_launches)
        open(out, "w").write(json.dumps(report))


dev = resolve_device("cuda")
torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
cm = CheckpointManager({ckpt!r}, save_every_n_steps=cs.CKPT_EVERY, async_write=False,
                       device=dev)
net = cm.restore_latest()
report["restored_step"] = None if net is None else net.iteration
if net is None:
    net = ComputationGraph(cs.resnet50_train_conf(), dev).init()
    net.set_listeners(Report(), FaultInjector(kill_at_step=cs.CKPT_KILL, kill_mode="process"))
else:
    net.set_listeners(Report())
i0 = net.iteration
net.fit(cs.ckpt_batches(torch, dev), num_epochs=cs.CKPT_EPOCHS, checkpoint_manager=cm)
cm.close()
report.update(steps=net.iteration - i0, iteration=net.iteration, epoch=net.epoch,
              state_sha=state_sha(net), bn_act_fwd=bn_act.fwd_launches,
              bn_act_bwd=bn_act.bwd_launches, done_s=time.time() - spawned)
open(out, "w").write(json.dumps(report))
'''


def supervised_phase(torch, dev, card, workdir, ckpt) -> dict:
    """train_until_process runs the checkpoint phase's ResNet50 schedule in a
    worker process on the card (a python3 -c program, local checkpoints
    every 3 steps, written synchronously). The first attempt is killed by a
    real SIGKILL at step 7 (FaultInjector(kill_mode="process")); the
    supervisor respawns it (respawn_preempted), the respawn restores step 6
    and finishes. Held: the supervisor's summary (one restart, the crash a
    Preempted SIGKILL at store step 6), and the final state_sha equal to
    the checkpoint phase's uninterrupted run. Prints each attempt's
    seconds from spawn to its first step, and the crash record. The
    workers use the kernels this script built (build/ holds them), and
    report their own bn_act launches after every step (the killed one up
    to the step it died after)."""
    import dataclasses

    from deeplearning4j_tpu_torch.checkpoint import CheckpointManager, RestartPolicy
    from deeplearning4j_tpu_torch.checkpoint.supervisor import train_until_process

    t_phase = time.perf_counter()
    root = os.path.dirname(os.path.abspath(__file__))
    store = os.path.join(workdir, "store")
    prog = SUPERVISED_WORKER.format(root=root, workdir=workdir, ckpt=store)
    torch.cuda.empty_cache()
    watcher = CheckpointManager(store, device=dev)
    summary = train_until_process(
        lambda i, attempt: [sys.executable, "-c", prog, repr(time.time()), str(attempt)],
        respawn_preempted=True, checkpoint_manager=watcher,
        restart_policy=RestartPolicy(max_restarts=2, backoff_s=0.0),
        attempt_timeout_s=SUPERVISED_ATTEMPT_S, overall_timeout_s=SUPERVISED_OVERALL_S,
        cwd=root, log_dir=os.path.join(workdir, "logs"))
    attempts = []
    for a in (1, 2):
        path = os.path.join(workdir, f"attempt{a}.json")
        attempts.append(json.load(open(path)) if os.path.exists(path) else None)
    tails = {}
    for i, logs in summary.logs.items():
        for p in logs:
            tails[os.path.basename(p)] = open(p, errors="replace").read()[-2000:]
    crash = [dataclasses.asdict(c) for c in summary.crashes]
    ok = (summary.completed and summary.restarts == 1 and len(crash) == 1
          and crash[0]["error_type"] == "Preempted"
          and crash[0]["error"] == "killed by SIGKILL"
          and crash[0]["crashed_at_step"] == CKPT_RESTORED[0]
          and crash[0]["restored_step"] == CKPT_RESTORED[0]
          and None not in attempts and attempts[1].get("restored_step") == CKPT_RESTORED[0])
    if not ok:
        raise AssertionError(f"supervised: summary {summary}, crashes {crash}, attempts "
                             f"{attempts}, worker logs {tails}")
    final = attempts[1]
    if final["state_sha"] != ckpt["state_sha"]:
        raise AssertionError(f"supervised: the respawned worker's final state_sha "
                             f"{final['state_sha']} differs from the uninterrupted run's "
                             f"{ckpt['state_sha']}")
    killed = attempts[0]
    fwd = killed["bn_act_fwd"] + final["bn_act_fwd"]
    bwd = killed["bn_act_bwd"] + final["bn_act_bwd"]
    steps = killed["steps_done"] + final["steps_done"]
    if killed["steps_done"] != CKPT_KILL or not fwd == bwd == RESNET50_FUSED_BLOCKS * steps:
        raise AssertionError(f"supervised: bn_act launched {fwd} / {bwd} times in {steps} "
                             f"steps over both attempts: {attempts}")
    out = {"card": card, "kill": "SIGKILL at step 7 (FaultInjector kill_mode='process')",
           "restarts": summary.restarts, "crash_record": crash,
           "worker_status": summary.worker_status,
           "spawn_to_first_step_s": [a["first_step_s"] for a in attempts],
           "spawn_to_imports_s": [a["import_s"] for a in attempts],
           "respawn_restored_step": final["restored_step"],
           "respawn_steps": final["steps"], "respawn_spawn_to_done_s": final["done_s"],
           "final_state_sha": final["state_sha"], "equals_uninterrupted": True,
           "bn_act_launches_by_attempt": [[a["bn_act_fwd"], a["bn_act_bwd"]] for a in attempts],
           "wall_time_s": summary.wall_time_s, "seconds": time.perf_counter() - t_phase}
    print("supervised " + json.dumps(out), flush=True)
    return {"fwd": fwd, "bwd": bwd}


# ------------------------------------------------ slice 17: leaf modules
# a planted-partition graph with BlogCatalog's size (Tang & Liu 2009: 10,312
# vertices, 333,983 edges, 39 groups): each edge inside one block with
# probability GRAPH_P_IN, else between two random vertices; seeded
GRAPH_V, GRAPH_E, GRAPH_BLOCKS, GRAPH_P_IN, GRAPH_SEED = 10_312, 333_983, 39, 0.8, 17
# DeepWalk at the paper's widths (Perozzi et al. 2014: d 128, walk length 40,
# window 10; 5 negatives), walks per vertex cut from 80 to 3 (10, then 5,
# before; 3 reach a block share of 0.89 where the gate asks 0.25, 2 fell to
# 0.097 on the card); Node2Vec (Grover & Leskovec 2016: p 1, q
# 0.5, walk length 80, window 10), one walk per vertex; both at the
# Word2Vec phase's batch of 8192 pairs. Node2Vec's one walk a vertex draws
# a fraction of DeepWalk's pairs: at the default rate
# 0.025 a 3,000-vertex graph on the CPU stayed at the chance share, at 0.1
# it reached 1.0
DEEPWALK_KW = dict(vector_size=128, window_size=10, walk_length=40, walks_per_vertex=3,
                   negative=5, batch_size=8192, seed=5)
NODE2VEC_KW = dict(p=1.0, q=0.5, vector_size=128, window_size=10, walk_length=80,
                   walks_per_vertex=1, negative=5, batch_size=8192, learning_rate=0.1, seed=5)
# the block-agreement check: sampled vertices, neighbours each; a fit must
# reach BLOCK_GATE (10x the 1/39 chance share), its shuffled-id control
# must not
BLOCK_SAMPLE, BLOCK_K, BLOCK_GATE = 1000, 10, 0.25
TREE_QUERIES, TREE_K = 10, 10  # cut from 25 to hold the script's time
# BarnesHutTsne's iterations (cut from the JAX default 1,000 to hold the
# script's time: the KL had flattened by 500, 3.08 against 3.03 at 1,000), and the JAX package's size
# from which theta > 0 takes the approximate regime
TSNE_EXACT_N, TSNE_ITERS, TSNE_BH_THRESHOLD = 2000, 500, 8192
# a t-SNE step on the card against the same step on the CPU: each
# coordinate within TSNE_STEP_TOL of the embedding's largest magnitude
# (the grid's segment sums are index_add_ atomics on the card), KL within
# TSNE_STEP_TOL relative
TSNE_STEP_TOL = 1e-5


def planted_graph():
    """The seeded planted-partition graph (GRAPH_*) and each vertex's block."""
    from deeplearning4j_tpu_torch.graphs import Graph

    rng = np.random.default_rng(GRAPH_SEED)
    block = np.arange(GRAPH_V) % GRAPH_BLOCKS
    members = [np.flatnonzero(block == b) for b in range(GRAPH_BLOCKS)]
    sizes = np.array([len(m) for m in members])
    start = np.concatenate([[0], np.cumsum(sizes)[:-1]])
    flat = np.concatenate(members)
    a = rng.integers(0, GRAPH_V, GRAPH_E)
    inside = rng.random(GRAPH_E) < GRAPH_P_IN
    b = np.where(inside, flat[start[block[a]] + rng.integers(0, sizes[block[a]])],
                 rng.integers(0, GRAPH_V, GRAPH_E))
    b = np.where(b == a, (b + GRAPH_BLOCKS) % GRAPH_V, b)   # no self-loops, same block
    g = Graph(GRAPH_V)
    for x, y in zip(a.tolist(), b.tolist()):
        g.add_edge(x, y)
    return g, block


class _ScatterProbe:
    """Wraps the scatter_add the NLP steps call: the first launch's operands
    and result are kept, to be held against the plain version."""

    def __init__(self, torch):
        from deeplearning4j_tpu_torch.nlp import kernels
        self.torch, self.kernels, self.real = torch, kernels, kernels.scatter_add
        self.kept = None

    def __enter__(self):
        def probe(table, idx, grads):
            if self.kept is not None:
                return self.real(table, idx, grads)
            before = table.clone()
            out = self.real(table, idx, grads)
            self.kept = (before, idx.clone(), grads.clone(), out.clone())
            return out
        self.kernels.scatter_add = probe
        return self

    def __exit__(self, *exc):
        self.kernels.scatter_add = self.real

    def hold(self, what) -> dict:
        from deeplearning4j_tpu_torch.perf.kernels import scatter_add as sa
        before, idx, grads, got = self.kept
        want = sa.scatter_add_plain(before.clone(), idx, grads)
        if not _bits_equal(self.torch, got, want):
            raise AssertionError(f"{what}: a sampled scatter_add launch differs from its "
                                 f"plain version (max |diff| "
                                 f"{float((got - want).abs().max())})")
        return {"V": int(before.shape[0]), "D": int(before.shape[1]), "N": int(idx.shape[0]),
                "bitwise_vs_plain": True}


def _timed_walks(model, walks=None) -> dict:
    """Hook ``model``'s walk iterator: time its walks and keep them, or serve
    ``walks`` (a control's) instead of drawing."""
    record = {"seconds": 0.0, "walks": []}
    make = model._make_walk_iterator

    def hooked(graph, length):
        it = make(graph, length)
        draw = it.walks

        def walks_of(epoch=0):
            if walks is not None:
                return walks[epoch]
            t0 = time.perf_counter()
            out = draw(epoch)
            record["seconds"] += time.perf_counter() - t0
            record["walks"].append(out)
            return out
        it.walks = walks_of
        return it
    model._make_walk_iterator = hooked
    return record


def _graph_fit(torch, cls, kw, dev, graph, walks=None, probe=True) -> tuple:
    """One fit through the model's own ``fit(graph)``: walk and fit seconds,
    words/s, the launches of every kernel and one scatter_add launch held
    against the plain version."""
    model = cls(device=dev, **kw)
    rec = _timed_walks(model, walks)
    _zero_launch_counts()
    t0 = time.perf_counter()
    with _ScatterProbe(torch) as p:
        model.fit(graph)
        torch.cuda.synchronize()
    total = time.perf_counter() - t0
    launches = _launch_counts()
    sv = model._vectors
    batches = sv.counters["corpus_batches"]
    if launches["scatter_add"] != 3 * batches or batches == 0 or sv.counters["batches"]:
        raise AssertionError(f"{cls.__name__}: scatter_add launched "
                             f"{launches['scatter_add']} times in {batches} corpus batches "
                             f"(want 3 each), host batches {sv.counters['batches']}")
    if any(n for k, n in launches.items() if k != "scatter_add"):
        raise AssertionError(f"{cls.__name__}: another kernel ran: {launches}")
    if not np.isfinite(sv.loss_history).all():
        raise AssertionError(f"{cls.__name__}: a loss is not finite: {sv.loss_history}")
    held = p.hold(cls.__name__) if probe else None
    words = sv.vocab.total_word_occurrences
    fit_s = total - rec["seconds"]
    return model, rec, {"walk_seconds": rec["seconds"], "fit_seconds": fit_s,
                        "tokens": words, "words_per_s": words / fit_s,
                        "corpus_batches": batches,
                        "scatter_add_launches": launches["scatter_add"],
                        "loss_per_epoch": sv.loss_history, "sampled_launch": held}


def _block_share(model, block, sample) -> float:
    """The share of same-block vertices among ``verts_nearest(v, BLOCK_K)``
    over the sampled vertices."""
    same = [np.mean(block[model.verts_nearest(int(v), BLOCK_K)] == block[v]) for v in sample]
    return float(np.mean(same))


def _shuffled(walk_sets, perm):
    return [[[int(perm[v]) for v in w] for w in walks] for walks in walk_sets]


def _brute_ids(torch, dev, items, queries, k, exclude=None) -> np.ndarray:
    """The k nearest rows of ``items`` to each query by a float64
    torch.cdist on the card (no matmul expansion), ordered by (distance,
    index); ``exclude[i]`` drops one id from row i's answer."""
    x = torch.as_tensor(items, dtype=torch.float64, device=dev)
    q = torch.as_tensor(queries, dtype=torch.float64, device=dev)
    d = torch.cdist(q, x, compute_mode="donot_use_mm_for_euclid_dist")
    if exclude is not None:
        d[torch.arange(len(exclude), device=dev),
          torch.as_tensor(exclude, device=dev)] = float("inf")
    order = torch.sort(d, dim=1, stable=True).indices[:, :k]
    return order.cpu().numpy()


def _tree_checks(torch, dev, vectors, rng) -> dict:
    from deeplearning4j_tpu_torch.clustering import KDTree, NearestNeighborsServer, VPTree

    items = vectors.astype(np.float64)
    sample = rng.choice(len(items), TREE_QUERIES, replace=False)
    want = _brute_ids(torch, dev, items, items[sample], TREE_K)
    out = {}
    for cls in (VPTree, KDTree):
        t0 = time.perf_counter()
        tree = cls(items)
        build_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        got = np.array([tree.search(items[v], TREE_K)[0] for v in sample])
        query_s = time.perf_counter() - t0
        if not np.array_equal(got, want):
            bad = int(np.sum(np.any(got != want, axis=1)))
            raise AssertionError(f"{cls.__name__}: {bad} of {TREE_QUERIES} answers differ "
                                 "from the card's brute force")
        out[cls.__name__] = {"build_s": build_s, "ms_per_query": 1e3 * query_s / TREE_QUERIES}
    srv = NearestNeighborsServer(items).start(port=0)
    try:
        want = _brute_ids(torch, dev, items, items[sample], TREE_K, exclude=sample)
        t0 = time.perf_counter()
        for row, v in enumerate(sample):
            code, body, _, _ = _http(f"http://127.0.0.1:{srv.port}", "POST", "/knn",
                                     {"index": int(v), "k": TREE_K})
            ids = [r["index"] for r in body["results"]] if code == 200 else body
            if code != 200 or ids != want[row].tolist():
                raise AssertionError(f"NearestNeighborsServer /knn {int(v)}: {code} {ids}, "
                                     f"want {want[row].tolist()}")
        out["NearestNeighborsServer"] = {
            "ms_per_request": 1e3 * (time.perf_counter() - t0) / TREE_QUERIES}
    finally:
        srv.stop()
    out.update(queries=TREE_QUERIES, k=TREE_K, ids="equal to the card's float64 brute force")
    return out


def _tsne_block_share(torch, dev, emb, block, sample) -> float:
    """The same-block share among each sampled point's BLOCK_K nearest in
    the 2-D embedding."""
    ids = _brute_ids(torch, dev, emb, emb[sample], BLOCK_K, exclude=sample)
    return float(np.mean(block[ids] == block[sample][:, None]))


def _tsne_step_vs_cpu(torch, dev, x, regime) -> dict:
    """One t-SNE step on the card and on the CPU from the same state (the
    JAX defaults' perplexity, the first exaggerated iteration)."""
    from deeplearning4j_tpu_torch.plot import tsne as T

    n = x.shape[0]
    rng = np.random.default_rng(11)
    if regime == "exact":
        p = T._conditional_probs(x, 30.0)
        p = np.maximum((p + p.T) / (2.0 * n), 1e-12).astype(np.float32) * np.float32(12.0)
        y = rng.standard_normal((n, 2)).astype(np.float32)
        args = [y, p, np.ones_like(y), np.zeros_like(y)]

        def step(d):
            return T._tsne_step(*[torch.as_tensor(a, device=d) for a in args], 0.5, 200.0)
    else:
        idx, d2 = T._knn_graph(x, 90, dev)
        nbr_idx, nbr_val = T._symmetrize_sparse(idx, T._knn_probs(d2, 30.0))
        n_pad = -(-n // 1024) * 1024
        pad = ((0, n_pad - n), (0, 0))
        y = np.pad(rng.standard_normal((n, 2)).astype(np.float32), pad)
        wpt = np.pad(np.ones(n, np.float32), (0, n_pad - n))
        args = [y, wpt, np.pad(nbr_idx, pad).astype(np.int64),
                np.pad(nbr_val, pad) * np.float32(12.0), np.ones_like(y), np.zeros_like(y)]

        def step(d):
            return T._bh_step(*[torch.as_tensor(a, device=d) for a in args], 0.5, 200.0,
                              64, 1024)
    with T._full_float32():
        card = [t.cpu().numpy() if t.dim() else float(t) for t in step(dev)]
        cpu = [t.numpy() if t.dim() else float(t) for t in step("cpu")]
    err = float(np.abs(card[0][:n] - cpu[0][:n]).max())
    scale = float(np.abs(cpu[0][:n]).max())
    kl_rel = abs(card[3] - cpu[3]) / abs(cpu[3])
    if err > TSNE_STEP_TOL * scale or kl_rel > TSNE_STEP_TOL:
        raise AssertionError(f"t-SNE {regime} step: card vs CPU max |dy| {err} "
                             f"(limit {TSNE_STEP_TOL * scale}), KL rel {kl_rel}")
    return {"max_abs_dy": err, "limit": TSNE_STEP_TOL * scale, "kl_rel_diff": kl_rel}


def _tsne_run(torch, dev, x, regime) -> tuple:
    from deeplearning4j_tpu_torch.plot import BarnesHutTsne

    tsne = BarnesHutTsne(device=dev, theta=0.5 if regime == "bh" else 0.0,
                         max_iter=TSNE_ITERS, bh_threshold=TSNE_BH_THRESHOLD)
    if (regime == "bh") != (x.shape[0] >= tsne.bh_threshold):
        raise AssertionError(f"t-SNE {regime} at n = {x.shape[0]}: the other regime would run")
    t0 = time.perf_counter()
    emb = tsne.fit_transform(x)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    if emb.shape != (x.shape[0], 2) or not np.isfinite(emb).all():
        raise AssertionError(f"t-SNE {regime}: embedding {emb.shape} not finite")
    return emb, {"n": x.shape[0], "seconds": seconds,
                 "iterations_per_s": tsne.max_iter / seconds, "kl_history": tsne.kl_history}


def graph_embeddings_phase(torch, dev, card) -> dict:
    """DeepWalk and Node2Vec on the seeded planted-partition graph of
    BlogCatalog's size (GRAPH_*), each through its fit on the card (walks
    drawn on the host, skip-gram on the corpus-resident SequenceVectors
    path, so every table update is a scatter_add launch: 3 a batch, no
    other kernel), the first launch of each fit held bitwise against
    scatter_add's plain version. Quality: the share of same-block vertices
    among verts_nearest(v, 10) over 1,000 sampled vertices must reach
    BLOCK_GATE, which a control trained on the same walks with the vertex
    ids shuffled must miss. VPTree, KDTree and NearestNeighborsServer's
    /knn over the DeepWalk vectors answer the ids of a float64 torch.cdist
    brute force on the card, ordered by (distance, index). BarnesHutTsne
    at the JAX defaults (perplexity 30, exaggeration 12), TSNE_ITERS iterations,
    in the approximate regime on all 10,312 vectors and in the exact
    regime on 2,000 of them, each with the 2-D block share against the
    control's embedding; one step of each regime on the card against the
    CPU within TSNE_STEP_TOL. Prints walk and fit seconds, words/s,
    launches, iterations/s and the KL histories."""
    from deeplearning4j_tpu_torch.graphs import DeepWalk, Node2Vec

    t_phase = time.perf_counter()
    t0 = time.perf_counter()
    graph, block = planted_graph()
    graph_s = time.perf_counter() - t0
    rng = np.random.default_rng(GRAPH_SEED + 1)
    sample = rng.choice(GRAPH_V, BLOCK_SAMPLE, replace=False)
    perm = rng.permutation(GRAPH_V)
    out = {"card": card, "graph": {"vertices": GRAPH_V, "edges": GRAPH_E,
                                   "blocks": GRAPH_BLOCKS, "p_in": GRAPH_P_IN,
                                   "build_s": graph_s},
           "reduced": {"deepwalk_walks_per_vertex": f"80 -> {DEEPWALK_KW['walks_per_vertex']}",
                       "node2vec_walks_per_vertex": 1,
                       "tsne_iterations": f"1000 -> {TSNE_ITERS}"}}
    launches, models = {}, {}
    for name, cls, kw in (("deepwalk", DeepWalk, DEEPWALK_KW),
                          ("node2vec", Node2Vec, NODE2VEC_KW)):
        model, rec, row = _graph_fit(torch, cls, kw, dev, graph)
        launches[name] = row["scatter_add_launches"]
        row["block_share"] = _block_share(model, block, sample)
        control, _, crow = _graph_fit(torch, cls, kw, dev, graph,
                                      walks=_shuffled(rec["walks"], perm), probe=False)
        row["control_block_share"] = _block_share(control, block, sample)
        row["control_fit_seconds"] = crow["fit_seconds"]
        if not row["block_share"] >= BLOCK_GATE > row["control_block_share"]:
            raise AssertionError(f"{name}: block share {row['block_share']} against the "
                                 f"gate {BLOCK_GATE}, control {row['control_block_share']}")
        models[name] = (model, control)
        print(f"graph_embeddings_{name} " + json.dumps(row), flush=True)
        out[name] = row
    dw, dw_control = models["deepwalk"]
    vectors = dw._vectors.get_word_vector_matrix()
    order = np.array([int(dw._vectors.vocab.word_at_index(i)) for i in range(GRAPH_V)])
    x = np.empty_like(vectors)
    x[order] = vectors                               # row v is vertex v's vector
    cv = dw_control._vectors.get_word_vector_matrix()
    corder = np.array([int(dw_control._vectors.vocab.word_at_index(i)) for i in range(GRAPH_V)])
    xc = np.empty_like(cv)
    xc[corder] = cv
    del models
    out["trees"] = _tree_checks(torch, dev, x, rng)
    tsne = {}
    for regime in ("bh", "exact"):
        rows = (np.arange(GRAPH_V) if regime == "bh"
                else np.sort(rng.choice(GRAPH_V, TSNE_EXACT_N, replace=False)))
        pick = rng.choice(len(rows), BLOCK_SAMPLE, replace=False)
        emb, row = _tsne_run(torch, dev, x[rows].astype(np.float64), regime)
        row["block_share"] = _tsne_block_share(torch, dev, emb, block[rows], pick)
        cemb, crow = _tsne_run(torch, dev, xc[rows].astype(np.float64), regime)
        row["control_block_share"] = _tsne_block_share(torch, dev, cemb, block[rows], pick)
        row["control_kl_last"] = crow["kl_history"][-1]
        if not row["block_share"] >= BLOCK_GATE > row["control_block_share"]:
            raise AssertionError(f"t-SNE {regime}: 2-D block share {row['block_share']}, "
                                 f"gate {BLOCK_GATE}, control {row['control_block_share']}")
        row["step_card_vs_cpu"] = _tsne_step_vs_cpu(torch, dev, x[rows].astype(np.float64),
                                                    regime)
        tsne[regime] = row
    out["tsne"] = tsne
    out["seconds"] = time.perf_counter() - t_phase
    print("graph_embeddings " + json.dumps({k: v for k, v in out.items()
                                            if k not in ("deepwalk", "node2vec")}), flush=True)
    return launches


# the sentence CNN (Kim 2014 at its widths): corpus size (the MR set's
# 10,662 sentences), train share, vector size, longest sentence, filter
# widths and maps, batch, epochs; a two-class synthetic corpus from
# CNN_SEED: sentences of 8-56 Zipf filler words with 1-3 cue words of
# their class and, with CNN_CROSS_P, one of the other class
CNN_SENTS, CNN_TRAIN, CNN_VEC, CNN_MAX_LEN = 10_662, 9_000, 300, 56
CNN_WIDTHS, CNN_MAPS, CNN_BATCH, CNN_EPOCHS, CNN_SEED = (3, 4, 5), 100, 50, 2, 23
CNN_FILLER, CNN_CUES, CNN_CROSS_P = 5_000, 10, 0.3
# the trained network's held-out accuracy must beat the shuffled-label
# control's by this much
CNN_MARGIN = 0.2
# the word vectors: at Word2Vec's default rate one pass over this corpus
# leaves the vectors at their initial scale (the mean loss stays at 6 ln 2
# and the CNN learns nothing from them, measured on the CPU at 64-d); at 0.3
# with batch 8192 every vector collapses onto one direction (cosine 0.999
# between the classes' cue words); 0.05 with batch 512 separates them
# (2 epochs, cut from 3 to hold the script's time: held-out accuracy 0.93
# against the control's 0.51)
CNN_W2V_KW = dict(window_size=5, negative=5, epochs=2, learning_rate=0.05, batch_size=512,
                  min_word_frequency=1, seed=CNN_SEED)


def sentence_corpus():
    rng = np.random.default_rng(CNN_SEED)
    filler = [f"w{i}" for i in range(CNN_FILLER)]
    zipf = 1.0 / np.arange(1, CNN_FILLER + 1)
    zipf /= zipf.sum()
    cues = {0: [f"neg{i}" for i in range(CNN_CUES)], 1: [f"pos{i}" for i in range(CNN_CUES)]}
    sents, labels = [], []
    for _ in range(CNN_SENTS):
        label = int(rng.integers(0, 2))
        words = [filler[i] for i in rng.choice(CNN_FILLER, int(rng.integers(8, CNN_MAX_LEN - 3)),
                                               p=zipf)]
        extra = [cues[label][i] for i in rng.integers(0, CNN_CUES, int(rng.integers(1, 4)))]
        if rng.random() < CNN_CROSS_P:
            extra.append(cues[1 - label][int(rng.integers(0, CNN_CUES))])
        for w in extra:
            words.insert(int(rng.integers(0, len(words) + 1)), w)
        sents.append(" ".join(words[:CNN_MAX_LEN]))
        labels.append("pos" if label else "neg")
    return sents, labels


def sentence_cnn_conf():
    from deeplearning4j_tpu_torch.nn.conf import InputType, NeuralNetConfiguration
    from deeplearning4j_tpu_torch.nn.conf.convolutional import ConvolutionLayer
    from deeplearning4j_tpu_torch.nn.conf.graph import GraphBuilder, MergeVertex
    from deeplearning4j_tpu_torch.nn.conf.layers import DropoutLayer, OutputLayer
    from deeplearning4j_tpu_torch.nn.conf.pooling import GlobalPoolingLayer
    from deeplearning4j_tpu_torch.optimize.updaters import Adam

    parent = (NeuralNetConfiguration.builder().seed(CNN_SEED).updater(Adam(1e-3))
              .weight_init("relu"))
    g = GraphBuilder(parent).add_inputs("in")
    for w in CNN_WIDTHS:
        g.add_layer(f"conv{w}", ConvolutionLayer(n_out=CNN_MAPS, kernel_size=(w, CNN_VEC),
                                                 activation="relu"), "in")
        g.add_layer(f"pool{w}", GlobalPoolingLayer(pooling_type="max"), f"conv{w}")
    g.add_vertex("merge", MergeVertex(), *[f"pool{w}" for w in CNN_WIDTHS])
    g.add_layer("drop", DropoutLayer(dropout=0.5), "merge")
    g.add_layer("out", OutputLayer(n_out=2, activation="softmax", loss="mcxent"), "drop")
    return (g.set_outputs("out")
            .set_input_types(InputType.convolutional(CNN_MAX_LEN, CNN_VEC, 1)).build())


def _cnn_train(torch, dev, batches, test):
    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph

    net = ComputationGraph(sentence_cnn_conf(), dev).init()
    losses = []
    t0 = time.perf_counter()
    for _ in range(CNN_EPOCHS):
        for ds in batches:
            net.fit(ds)
            losses.append(net.score())
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    right = sum(int(np.sum(net.predict(ds.features, features_masks=[ds.features_mask])
                           == np.argmax(ds.labels, 1))) for ds in test)
    n = sum(ds.num_examples() for ds in test)
    return losses, right / n, seconds


def cnn_sentence_phase(torch, dev, card) -> dict:
    """The sentence CNN of Kim 2014 at its widths on the card: the port's
    Word2Vec (300-d, on the card, CNN_W2V_KW) trained on the seeded
    two-class corpus, CnnSentenceDataSetIterator (batch 50, at most 56
    words, unknown words removed) laying each batch out as (50, T, 300, 1)
    with its per-step feature mask from that Word2Vec's vectors, and a
    ComputationGraph of 3/4/5-wide convolutions of 100 maps each, max over
    time (GlobalPoolingLayer), MergeVertex, dropout 0.5 and a softmax,
    trained with Adam 1e-3 for 2 epochs over 9,000 sentences through fit.
    Held: every loss finite, the mean of the last 20 below the first 20's;
    the held-out accuracy on the other 1,662 beats by CNN_MARGIN the same
    network trained on the labels shuffled. No kernel of the port runs
    (the convolutions are cuDNN's)."""
    from deeplearning4j_tpu_torch.datasets import DataSet
    from deeplearning4j_tpu_torch.nlp import (CnnSentenceDataSetIterator,
                                              CollectionLabeledSentenceProvider, Word2Vec)

    t_phase = time.perf_counter()
    sents, labels = sentence_corpus()
    t0 = time.perf_counter()
    w2v = Word2Vec(layer_size=CNN_VEC, device=dev, **CNN_W2V_KW).fit(sents)
    torch.cuda.synchronize()
    w2v_s = time.perf_counter() - t0

    def batches(lo, hi, seed):
        it = CnnSentenceDataSetIterator(
            CollectionLabeledSentenceProvider(sents[lo:hi], labels[lo:hi], seed=seed), w2v,
            batch_size=CNN_BATCH, max_sentence_length=CNN_MAX_LEN)
        return list(it)

    t0 = time.perf_counter()
    train, test = batches(0, CNN_TRAIN, CNN_SEED), batches(CNN_TRAIN, CNN_SENTS, None)
    layout_s = time.perf_counter() - t0
    first = train[0]
    if first.features.shape[0] != CNN_BATCH or first.features.shape[2:] != (CNN_VEC, 1) \
            or first.features_mask.shape != first.features.shape[:2]:
        raise AssertionError(f"cnn_sentence: batch {first.features.shape}, mask "
                             f"{first.features_mask.shape}")
    _zero_launch_counts()
    losses, accuracy, seconds = _cnn_train(torch, dev, train, test)
    launches = _launch_counts()
    rng = np.random.default_rng(CNN_SEED + 1)
    shuffled_labels = rng.permutation(np.concatenate([ds.labels for ds in train]))
    control_train, at = [], 0
    for ds in train:
        n = ds.num_examples()
        control_train.append(DataSet(ds.features, shuffled_labels[at:at + n],
                                     features_mask=ds.features_mask))
        at += n
    c_losses, c_accuracy, _ = _cnn_train(torch, dev, control_train, test)
    first20, last20 = float(np.mean(losses[:20])), float(np.mean(losses[-20:]))
    if not (np.isfinite(losses).all() and last20 < first20):
        raise AssertionError(f"cnn_sentence: losses {losses[:5]} ... {losses[-5:]}")
    if any(launches.values()):
        raise AssertionError(f"cnn_sentence: a kernel of the port ran: {launches}")
    if not accuracy > c_accuracy + CNN_MARGIN:
        raise AssertionError(f"cnn_sentence: held-out accuracy {accuracy}, shuffled-label "
                             f"control {c_accuracy}")
    steps = CNN_EPOCHS * len(train)
    summary = {"card": card, "sentences": CNN_SENTS, "train": CNN_TRAIN,
               "word2vec": {"layer_size": CNN_VEC, "tokens": w2v.vocab.total_word_occurrences,
                            "vocab": w2v.vocab.num_words(), "seconds": w2v_s},
               "layout_s": layout_s, "batch": CNN_BATCH, "max_len": CNN_MAX_LEN,
               "filters": [list(CNN_WIDTHS), CNN_MAPS], "epochs": CNN_EPOCHS, "steps": steps,
               "step_ms": 1e3 * seconds / steps, "sentences_per_s": steps * CNN_BATCH / seconds,
               "loss_first20": first20, "loss_last20": last20,
               "heldout_accuracy": accuracy, "control_heldout_accuracy": c_accuracy,
               "control_loss_last": c_losses[-1], "seconds": time.perf_counter() - t_phase}
    print("cnn_sentence " + json.dumps(summary), flush=True)
    return summary


# ------------------------------------------------ slice 18: data-parallel tier
PAR_COMP_STEPS = 20      # the compressed run: one batch, as the training phase
ELASTIC_BATCHES = 3      # batches an epoch of the elastic run (2 epochs)
ELASTIC_HANG_S = 2.0     # the deliberately hung guarded call's deadline
# residual_norm sums 25.6 M squares as a tree on the card and in blocks on
# the CPU: each reduction is within log2(n) ~ 25 units of roundoff (2**-24)
# of the sum, so two differ by at most 50 of them; the sqrt halves that
RNORM_RTOL = 50 * 2.0 ** -24 / 2


class _StepClock:
    """Listener: the card's wall time of each step (synchronizes after
    every update, a timing run) and each step's loss tensor."""

    def __init__(self, torch):
        self.torch, self.marks, self.losses = torch, [], []

    def iteration_done(self, model, iteration, epoch):
        self.torch.cuda.synchronize()
        self.marks.append(time.perf_counter())
        self.losses.append(model._score)

    def on_epoch_start(self, model):
        if not self.marks:
            self.torch.cuda.synchronize()
            self.marks.append(time.perf_counter())

    def on_epoch_end(self, model):
        pass

    def step_ms(self):
        d = np.diff(self.marks) * 1e3
        return [float(v) for v in d]


def _free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _sync_warnings(torch, fn) -> int:
    """Host syncs ``fn`` makes on the card, counted by
    torch.cuda.set_sync_debug_mode("warn")."""
    import warnings
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            fn()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    return sum("synchroniz" in str(w.message).lower() for w in caught)


def _apply_card_vs_cpu(torch, dev, params) -> dict:
    """One ThresholdCompression apply, twice (the second on a nonzero
    residual), on the card and on the CPU on the same float32 gradient
    tree of ResNet50's shapes: decoded gradients, residuals, tau and byte
    counters bitwise; residual_norm within RNORM_RTOL."""
    from deeplearning4j_tpu_torch.parallel.compress import (ThresholdCompression, _leaves,
                                                            _rebuild, compress_state_arrays)
    scheme = ThresholdCompression()
    gen = torch.Generator()
    gen.manual_seed(18)
    leaves = _leaves(params)
    states = {"card": scheme.init_state(params), "cpu": None}
    cpu_params = _rebuild(params, {p: torch.empty(t.shape) for p, t in leaves})
    states["cpu"] = scheme.init_state(cpu_params)
    worst = {}
    for step in range(2):
        host = {p: torch.randn(t.shape, generator=gen) * 1e-3 for p, t in leaves}
        g_cpu = _rebuild(params, host)
        g_card = _rebuild(params, {p: v.to(dev) for p, v in host.items()})
        dec_card, states["card"] = scheme.apply(g_card, states["card"])
        dec_cpu, states["cpu"] = scheme.apply(g_cpu, states["cpu"])
        for (p, a), (_, b) in zip(_leaves(dec_card), _leaves(dec_cpu)):
            if not torch.equal(a.cpu(), b):
                raise AssertionError(f"parallel_training: decoded {p} differs card vs CPU")
        sc = compress_state_arrays(states["card"])
        for k, b in compress_state_arrays(states["cpu"]).items():
            a = sc[k].cpu()
            if k == "acc/residual_norm":
                rel = abs(float(a) - float(b)) / max(abs(float(b)), 1e-30)
                worst["residual_norm_rel"] = max(worst.get("residual_norm_rel", 0.0), rel)
                if rel > RNORM_RTOL:
                    raise AssertionError(f"parallel_training: residual_norm {float(a)} on "
                                         f"the card, {float(b)} on the CPU")
            elif not torch.equal(a, b):
                raise AssertionError(f"parallel_training: {k} differs card vs CPU")
    return {"steps": 2, "decoded_residual_tau_bytes": "bitwise",
            "residual_norm_rel_err": worst["residual_norm_rel"],
            "residual_norm_limit": RNORM_RTOL}


def _compress_device_ms(torch, dev, net, reps: int = 5) -> float:
    """Median CUDA-event ms of one ThresholdCompression apply over a
    gradient tree of the net's shapes (drawn on the card) with the net's
    own state."""
    from deeplearning4j_tpu_torch.parallel.compress import _leaves, _rebuild
    gen = torch.Generator(device=dev)
    gen.manual_seed(3)
    grads = _rebuild(net.params, {p: torch.randn(t.shape, generator=gen, device=dev) * 1e-3
                                  for p, t in _leaves(net.params)})
    out = []
    for _ in range(reps + 1):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        net.grad_compression.apply(grads, net.compress_state)
        end.record()
        end.synchronize()
        out.append(start.elapsed_time(end))
    return float(np.median(out[1:]))


def parallel_training_phase(torch, dev, card) -> dict:
    """ResNet50 of 17 (bf16, fused, Adam 1e-3) through the port's
    ClusterTrainer, under cudnn.deterministic, on CKPT_BATCHES batches of
    128 drawn on the card (one epoch):
    1. ComputationGraph.fit (the reference), ClusterTrainer.fit with no
       process group, and ClusterTrainer.fit in an NCCL group of world
       size 1 that the phase starts: parameters, running stats, Adam
       state and state_sha of both ClusterTrainer runs bitwise the
       reference's; the NCCL run launches one all-reduce a step (the
       float32 gradient bucket with the loss in it);
    2. in the same group, 20 steps with ThresholdCompression() on the first
       batch (the training phase's schedule): every loss finite, the last
       below the first; the compression ratio, tau and
       residual norm printed; one apply's device ms (CUDA events); the host
       syncs of one compressed step counted under
       torch.cuda.set_sync_debug_mode("warn") against one uncompressed
       step: compression adds none;
    3. one apply on the card against the CPU on the same gradient tree of
       ResNet50's shapes (bitwise, residual_norm within RNORM_RTOL).
    53 bn_act_fwd and 53 bn_act_bwd launches every step."""
    import torch.distributed as dist

    from deeplearning4j_tpu_torch.checkpoint.sharded import state_sha
    from deeplearning4j_tpu_torch.nn import data_parallel
    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
    from deeplearning4j_tpu_torch.parallel import (ClusterTrainer, ThresholdCompression,
                                                   compression_stats)
    from deeplearning4j_tpu_torch.perf.kernels import bn_act

    t_phase = time.perf_counter()
    conf = resnet50_train_conf()
    batches = ckpt_batches(torch, dev)
    n = len(batches)
    launches = {"parallel": {"fwd": 0, "bwd": 0}, "parallel_compressed": {"fwd": 0, "bwd": 0}}
    steps = {"parallel": 0, "parallel_compressed": 0}

    def run(path, fn, net):
        bn_act.fwd_launches = bn_act.bwd_launches = 0
        i0 = net.iteration
        fn()
        launches[path]["fwd"] += bn_act.fwd_launches
        launches[path]["bwd"] += bn_act.bwd_launches
        steps[path] += net.iteration - i0

    def fresh():
        net = ComputationGraph(conf, dev).init()
        clock = _StepClock(torch)
        net.set_listeners(clock)
        return net, clock

    flags = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    out = {"card": card, "batches": n, "batch": TRAIN_BATCH}
    try:
        net, clock = fresh()
        net.fit(batches)
        ref, ref_sha = _run_record(net), state_sha(net)
        out["fit_step_ms"] = float(np.median(clock.step_ms()[1:]))
        del net
        torch.cuda.empty_cache()

        net, clock = fresh()
        run("parallel", lambda: ClusterTrainer(net).fit(batches), net)
        diff = _differences(ref, _run_record(net))
        if diff or state_sha(net) != ref_sha:
            raise AssertionError(f"parallel_training: ClusterTrainer without a group differs "
                                 f"from ComputationGraph.fit in {len(diff)} arrays: {diff[:8]}")
        out["no_group_step_ms"] = float(np.median(clock.step_ms()[1:]))
        del net
        torch.cuda.empty_cache()

        dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{_free_port()}",
                                world_size=1, rank=0)
        try:
            net, clock = fresh()
            data_parallel.all_reduces = 0
            ct = ClusterTrainer(net)
            run("parallel", lambda: ct.fit(batches), net)
            per_step = data_parallel.all_reduces / n
            diff = _differences(ref, _run_record(net))
            if diff or state_sha(net) != ref_sha:
                raise AssertionError(f"parallel_training: ClusterTrainer in an NCCL group of "
                                     f"one differs from ComputationGraph.fit in {len(diff)} "
                                     f"arrays: {diff[:8]}")
            if per_step != 1:
                raise AssertionError(f"parallel_training: {data_parallel.all_reduces} "
                                     f"all-reduces in {n} steps, want one a step")
            out["nccl_step_ms"] = float(np.median(clock.step_ms()[1:]))
            out["nccl_all_reduces_per_step"] = per_step
            out["bitwise_vs_fit"] = {"no_group": True, "nccl_world_1": True,
                                     "compared_arrays": len(ref["arrays"])}
            net.set_listeners()  # no timing syncs in the counted step
            syncs_plain = _sync_warnings(torch, lambda: run("parallel",
                                                            lambda: ct.fit(batches[0]), net))
            del net, ct
            torch.cuda.empty_cache()

            net, clock = fresh()
            ct = ClusterTrainer(net, grad_compression=ThresholdCompression())
            run("parallel_compressed",
                lambda: ct.fit(batches[0], num_epochs=PAR_COMP_STEPS), net)
            losses = [float(v) for v in clock.losses]
            if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
                raise AssertionError(f"parallel_training: compressed losses {losses}")
            stats = compression_stats(net)
            net.set_listeners()
            syncs_comp = _sync_warnings(torch, lambda: run("parallel_compressed",
                                                           lambda: ct.fit(batches[0]), net))
            if syncs_comp > syncs_plain:
                raise AssertionError(f"parallel_training: a compressed step makes {syncs_comp} "
                                     f"host syncs, an uncompressed one {syncs_plain}")
            out["compressed"] = {
                "steps": len(losses), "first_loss": losses[0], "last_loss": losses[-1],
                "step_ms": float(np.median(clock.step_ms()[1:len(losses)])),
                "ratio": stats["last_ratio"], "tau": stats["tau"],
                "residual_norm": stats["residual_norm"],
                "wire_bytes_per_step": stats["last_wire_bytes"],
                "dense_bytes_per_step": stats["dense_bytes"] / stats["steps"],
                "apply_device_ms": _compress_device_ms(torch, dev, net),
                "host_syncs_per_step": {"uncompressed": syncs_plain,
                                        "compressed": syncs_comp}}
            out["apply_card_vs_cpu"] = _apply_card_vs_cpu(torch, dev, net.params)
            del net, ct
            torch.cuda.empty_cache()
        finally:
            dist.destroy_process_group()
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = flags
    for path, k in steps.items():
        want = RESNET50_FUSED_BLOCKS * k
        if not launches[path]["fwd"] == launches[path]["bwd"] == want:
            raise AssertionError(f"parallel_training: {path} launched bn_act "
                                 f"{launches[path]} in {k} steps; want {want} each")
    out.update(steps=steps, bn_act_launches=launches,
               seconds=time.perf_counter() - t_phase)
    print("parallel_training " + json.dumps(out), flush=True)
    return {kind: {p: launches[p][kind] for p in launches} for kind in ("fwd", "bwd")}


class _OnceListener:
    """Runs ``fn`` once, at the first step or the first epoch end."""

    def __init__(self, at, fn):
        self.at, self.fn, self.fired = at, fn, False

    def _maybe(self, where):
        if where == self.at and not self.fired:
            self.fired = True
            self.fn()

    def iteration_done(self, model, iteration, epoch):
        self._maybe("step")

    def on_epoch_start(self, model):
        pass

    def on_epoch_end(self, model):
        self._maybe("epoch")


def elastic_phase(torch, dev, card, workdir) -> dict:
    """ResNet50 of 17 through an ElasticWorker at world size 1 over a
    local store (2 epochs of ELASTIC_BATCHES batches, sharded checkpoints,
    cudnn.deterministic): generation 1 asks for a bump after epoch 1, so
    the worker checkpoints, tears down, re-forms generation 2 and restores;
    in generation 2 a guarded call that never returns (a
    CollectiveWatchdog of ELASTIC_HANG_S around a wait) raises
    CollectiveTimeoutError, which escalates to a bump, and generation 3
    restores the epoch-1 checkpoint and finishes. The final state_sha
    equals an uninterrupted ClusterTrainer run's; 53 + 53 bn launches
    every step. Prints the generations, the transition pauses and the
    checkpoint seconds."""
    from deeplearning4j_tpu_torch.checkpoint import CheckpointManager, LocalFSBackend
    from deeplearning4j_tpu_torch.checkpoint.sharded import state_sha
    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
    from deeplearning4j_tpu_torch.obs.registry import get_registry
    from deeplearning4j_tpu_torch.parallel import (ClusterTrainer, CollectiveWatchdog,
                                                   ElasticWorker)
    from deeplearning4j_tpu_torch.perf.kernels import bn_act

    t_phase = time.perf_counter()
    conf = resnet50_train_conf()
    batches = ckpt_batches(torch, dev)[:ELASTIC_BATCHES]
    epochs = 2
    release = threading.Event()
    flags = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    try:
        ref = ComputationGraph(conf, dev).init()
        ClusterTrainer(ref).fit(batches, num_epochs=epochs)
        ref_sha = state_sha(ref)
        del ref
        torch.cuda.empty_cache()

        def hang():
            CollectiveWatchdog(timeout_s=ELASTIC_HANG_S).call(
                release.wait, what="deliberately hung collective")

        def on_generation(model, m, rank, world):
            if m.generation == 1:
                model.add_listener(_OnceListener("epoch", lambda: worker.rendezvous
                                                 .request_bump(1, "bump after epoch 1")))
            elif m.generation == 2:
                model.add_listener(_OnceListener("step", hang))

        cm = CheckpointManager(os.path.join(workdir, "elastic_ck"), sharded=True,
                               async_write=False, device=dev)
        worker = ElasticWorker(store=LocalFSBackend(os.path.join(workdir, "rdzv")),
                               worker_id="card0", checkpoint_manager=cm, num_workers=1,
                               lease_ttl_s=60.0, poll_s=0.05, join_timeout_s=60.0,
                               collective_timeout_s=120.0, on_generation=on_generation)
        bn_act.fwd_launches = bn_act.bwd_launches = 0
        t0 = time.perf_counter()
        summary = worker.run(lambda: ComputationGraph(conf, dev).init(), batches,
                             num_epochs=epochs)
        run_s = time.perf_counter() - t0
        fwd, bwd = bn_act.fwd_launches, bn_act.bwd_launches
        model = summary.model
        final_sha = state_sha(model)
        del model, summary.model
        torch.cuda.empty_cache()
    finally:
        release.set()
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = flags
    gens = [{"generation": g.generation, "world": g.world_size, "epochs": g.epochs,
             "ended": g.ended, "restored": g.restored_from is not None,
             "wall_s": g.wall_s} for g in summary.generations]
    if not summary.completed or [g["generation"] for g in gens] != [1, 2, 3]:
        raise AssertionError(f"elastic: generations {gens}")
    if "bump requested" not in gens[0]["ended"] or "membership bump" not in gens[1]["ended"]:
        raise AssertionError(f"elastic: generations ended {[g['ended'] for g in gens]}")
    if final_sha != ref_sha:
        raise AssertionError("elastic: the final state_sha differs from the uninterrupted "
                             "ClusterTrainer run's")
    steps = ELASTIC_BATCHES + 1 + ELASTIC_BATCHES  # g1's epoch, g2's hung step, g3's epoch
    if not fwd == bwd == RESNET50_FUSED_BLOCKS * steps:
        raise AssertionError(f"elastic: bn_act launched {fwd} / {bwd} in {steps} steps; "
                             f"want {RESNET50_FUSED_BLOCKS * steps} each")
    pauses = get_registry().metric("elastic_transition_pause_ms")
    out = {"card": card, "batch": TRAIN_BATCH, "batches_per_epoch": ELASTIC_BATCHES,
           "epochs": epochs, "generations": gens, "state_sha_equal": True,
           "transition_pause_ms": [] if pauses is None else pauses.as_dict(),
           "checkpoints": [(e["step"], e["size"]) for e in cm.checkpoints()],
           "run_s": run_s, "steps": steps, "bn_act_fwd_launches": fwd,
           "bn_act_bwd_launches": bwd, "seconds": time.perf_counter() - t_phase}
    print("elastic " + json.dumps(out, default=str), flush=True)
    return {"fwd": fwd, "bwd": bwd}


# ------------------------------------ slice 19: model and sequence parallelism
DP2_STEPS = 3            # float32 steps of the world-2 run held against fit
DP2_WARM, DP2_TIMED = 2, 4   # bf16 steps of the world-2 run: warm-up, timed
DP2_LR = 1e-3            # Sgd's rate in the float32 run
# The float32 world-2 run against fit on the global batch. Each rank's
# batch-norm statistics and gradient sums are the whole batch's in another
# summation order (two halves, then an all-reduce), and cuDNN's weight
# gradients sum 64 images a rank instead of 128: roundoff only, which
# ResNet50's backward at initialisation amplifies far past the operations'
# own (the tests hold the two-rank algebra at small sizes). So both float32
# runs are held to a float64 referee (the unfused graph with the same
# parameters, float64 compute, float32 masters, fit): the whole update
# (the parameters' change over the steps, as one vector of 25.6 M numbers)
# of the world-2 run within DP2_REFEREE_FACTOR times fit's own distance
# from the referee, and so the worst leaf (each leaf's distance over its
# own update). A loss is one number: each loss within DP2_LOSS_RTOL of the
# referee's (sound runs read 4.73e-4 at world 2 and 1.54e-4 through fit),
# and the first, which reads the initial parameters through the forward
# alone with no backward to amplify roundoff, within DP2_FIRST_LOSS_RTOL
# (float32 roundoff over ResNet50's 50 layers: about 1e-6). The negative
# control (the same world-2 steps with each rank's own batch statistics,
# what a step without global batch norm computes) must break a limit, or
# the check has no power
DP2_REFEREE_FACTOR, DP2_LOSS_RTOL, DP2_FIRST_LOSS_RTOL = 3.0, 1e-3, 1e-5
DP2_BN_CASES = [("res2", 56 * 56, 256, "bfloat16", "relu", True),
                ("res4", 14 * 14, 1024, "float32", "leakyrelu", True)]
MP_STEPS = 3             # ParallelWrapper(tensor_parallel=True) steps against fit
RING_SHAPE = (8, 12, 1024, 64)   # the LM's attention, causal float32
RING_LIMIT = 1e-5        # of max |v|: flash_attn_fwd's float32 limit
RING_GRAD_LIMIT = 1e-4   # of each gradient's largest magnitude
GPIPE_BLOCKS, GPIPE_D, GPIPE_F = 12, 768, 3072   # GPT-2 small's MLP widths
GPIPE_M, GPIPE_MB, GPIPE_STEPS, GPIPE_LR = 4, 1024, 3, 1e-1
# the pipeline sums a stage's microbatch gradients in reverse order, the
# sequential stack in autograd's order: 4 terms, a few units of roundoff
GPIPE_PARAM_TOL = 1e-6   # of each parameter's largest magnitude
SPLIT_CASES = [("res2", 401408, 256, "bfloat16", "relu", True),
               ("res2", 401408, 256, "float32", "identity", False),
               ("res4", 25088, 1024, "bfloat16", "relu", True),
               ("res4", 25088, 1024, "float32", "leakyrelu", True),
               ("ragged", 1001, 130, "float32", "leakyrelu", True),
               ("ragged", 1001, 130, "bfloat16", "leakyrelu", False)]
FLEET_TTL_S = 3.0        # replica lease TTL
FLEET_CLIENTS, FLEET_REQUESTS = 4, 12   # burst: client threads, bodies each
FLEET_KILL_AFTER = 16    # answered requests before one replica is SIGKILLed
FLEET_AFTER_S = 2.0      # the burst goes on this long past the killed lease's lapse
FLEET_HOPS = 15          # sequential 1-row requests, routed and direct, for the hop


def _count_collectives(torch):
    """Wrap nn/data_parallel's all-reduce to time each call after a device
    sync (the collective's own seconds, not the wait for the step's work);
    returns (the list of seconds, undo)."""
    from deeplearning4j_tpu_torch.nn import data_parallel

    inner, spent = data_parallel._all_reduce, []

    def timed(t):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = inner(t)
        torch.cuda.synchronize()
        spent.append(time.perf_counter() - t0)
        return out

    data_parallel._all_reduce = timed

    def undo():
        data_parallel._all_reduce = inner

    return spent, undo


def _dp2_batches(torch, dev, n, permuted=False):
    """``n`` global batches of 2 x 64 images and one-hot labels, drawn on the
    card from one seed (every process draws the same); ``permuted``: each
    batch's rows in another order (the same loss and gradients in exact
    arithmetic, other sums)."""
    from deeplearning4j_tpu_torch.datasets import DataSet

    gen = torch.Generator(device=dev)
    gen.manual_seed(19)
    eye = torch.eye(1000, device=dev)
    out = []
    for _ in range(n):
        x = torch.randn((TRAIN_BATCH, TRAIN_SIDE, TRAIN_SIDE, 3), generator=gen, device=dev)
        y = eye[torch.randint(0, 1000, (TRAIN_BATCH,), generator=gen, device=dev)]
        if permuted:
            order = torch.arange(TRAIN_BATCH, device=dev).roll(TRAIN_BATCH // 2 + 1).flip(0)
            x, y = x[order], y[order]
        out.append(DataSet(x, y))
    return out


def _dp2_float32_nets(dev, dtype="float32"):
    """(unfused, fused) float32 ResNet50 with Sgd DP2_LR, the fused one on
    the unfused one's parameters; the unfused one computes in ``dtype``."""
    import dataclasses

    from deeplearning4j_tpu_torch.models import ResNet50
    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
    from deeplearning4j_tpu_torch.optimize.updaters import Sgd
    from deeplearning4j_tpu_torch.perf.fusion import fuse_network

    conf = ResNet50(num_classes=1000, input_shape=(TRAIN_SIDE, TRAIN_SIDE, 3),
                    updater=Sgd(learning_rate=DP2_LR)).conf()
    net = ComputationGraph(dataclasses.replace(conf, dtype="float32"), dev).init()
    fused = fuse_network(net)
    if dtype != "float32":
        params, state = net.params, net.state
        net = ComputationGraph(dataclasses.replace(conf, dtype=dtype), dev)
        net.set_params(params, state)
    return net, fused


def _dp2_bn_check(torch, dev, rank, world) -> dict:
    """Each rank's split bn outputs (forward and backward, through the
    wrappers at world 2) held against the plain versions on the
    concatenated global batch, from the same global statistics."""
    import torch.distributed as dist

    from deeplearning4j_tpu_torch.nn import data_parallel
    from deeplearning4j_tpu_torch.perf.kernels import bn_act

    out = {}
    for case, hw, c, dtype_name, act, residual in DP2_BN_CASES:
        n = TRAIN_BATCH * hw
        (z, gamma, beta, res), _, dout = bn_operands(torch, dev, n, c, dtype_name, act,
                                                     residual)
        rows = slice(rank * n // world, (rank + 1) * n // world)
        zr, rr, dr = z[rows], None if res is None else res[rows], dout[rows]
        calls = bn_act.fwd_split_launches, bn_act.bwd_split_launches
        with data_parallel.data_group(None, world):
            fwd = bn_act.bn_act_fwd(act, BN_EPS, zr, gamma, beta, rr)
            dz, dg, db, dpre = bn_act.bn_act_bwd(act, BN_EPS, zr, gamma, beta, rr, fwd[1],
                                                 fwd[3], dr)
        if (bn_act.fwd_split_launches - calls[0], bn_act.bwd_split_launches - calls[1]) != (1, 1):
            raise AssertionError("data_parallel_world2: the wrappers did not take the split "
                                 "launches at world 2")
        sums = torch.stack([dg, db])
        dist.all_reduce(sums)
        label = f"world2 rank {rank} {case} {n}x{c} {dtype_name} {act}"
        p_out, p_mean, p_var, p_inv = bn_act.bn_act_fwd_plain(act, BN_EPS, z, gamma, beta, res)
        held = hold_bn_fwd(torch, label, (zr, gamma, beta, rr), act, fwd,
                           (p_out[rows], p_mean, p_var, p_inv))
        p_dz, p_dg, p_db, p_dpre = bn_act.bn_act_bwd_plain(act, BN_EPS, z, gamma, beta, res,
                                                           fwd[1], fwd[3], dout)
        dz_err = hold_bn_bwd(torch, label, (dz, sums[0], sums[1], dpre),
                             (p_dz[rows], p_dg, p_db, None if p_dpre is None else p_dpre[rows]))
        out[case] = dict(held, dz_max_abs_err=dz_err, rows=n // world, channels=c,
                         dtype=dtype_name)
    return out


def _local_sums(flat):
    """data_parallel.sum_over_ranks without the collective: this rank's
    statistics and sums alone (the negative control's per-rank statistics;
    the float32 forward's zero rows of the other ranks add nothing)."""
    return flat


def dp2_rank(rank, port, workdir) -> None:
    """One rank of the data_parallel_world2 phase (run in a worker process
    of its own on the one card; see data_parallel_world2_phase)."""
    import torch

    from deeplearning4j_tpu_torch.checkpoint.sharded import state_sha
    from deeplearning4j_tpu_torch.device import resolve_device
    from deeplearning4j_tpu_torch.nn import data_parallel
    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
    from deeplearning4j_tpu_torch.parallel import ClusterTrainer
    from deeplearning4j_tpu_torch.perf.kernels import bn_act

    dev = resolve_device("cuda")
    ClusterTrainer.initialize(f"tcp://127.0.0.1:{port}", num_processes=2, process_id=rank,
                              backend="gloo")
    report = {"rank": rank, "bn_check": _dp2_bn_check(torch, dev, rank, 2)}
    flags = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    net = _dp2_float32_nets(dev)[1]
    clock = _StepClock(torch)
    net.set_listeners(clock)
    bn_act.fwd_launches = bn_act.bwd_launches = 0
    bn_act.fwd_split_launches = bn_act.bwd_split_launches = 0
    data_parallel.all_reduces = 0
    ClusterTrainer(net).fit(_dp2_batches(torch, dev, DP2_STEPS))
    report["float32"] = {
        "losses": [float(v) for v in clock.losses], "step_ms": clock.step_ms(),
        "state_sha": state_sha(net), "all_reduces": data_parallel.all_reduces,
        "launches": [bn_act.fwd_launches, bn_act.bwd_launches],
        "split_launches": [bn_act.fwd_split_launches, bn_act.bwd_split_launches]}
    if rank == 0:
        torch.save({k: v.cpu() for k, v in _run_record_tensors(net).items()},
                   os.path.join(workdir, "dp2_float32.pt"))
    del net
    # the negative control: the same steps, the bn sums kept on each rank
    net = _dp2_float32_nets(dev)[1]
    clock = _StepClock(torch)
    net.set_listeners(clock)
    inner = data_parallel.sum_over_ranks
    data_parallel.sum_over_ranks = _local_sums
    try:
        ClusterTrainer(net).fit(_dp2_batches(torch, dev, DP2_STEPS))
    finally:
        data_parallel.sum_over_ranks = inner
    report["control"] = {"losses": [float(v) for v in clock.losses]}
    if rank == 0:
        torch.save({k: v.cpu() for k, v in _run_record_tensors(net).items()},
                   os.path.join(workdir, "dp2_control.pt"))
    del net
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = flags
    torch.cuda.empty_cache()
    net = ComputationGraph(resnet50_train_conf(), dev).init()
    clock = _StepClock(torch)
    net.set_listeners(clock)
    batches = _dp2_batches(torch, dev, 1)
    ct = ClusterTrainer(net)
    bn_act.fwd_split_launches = bn_act.bwd_split_launches = 0
    ct.fit(batches, num_epochs=DP2_WARM + DP2_TIMED)
    steps = clock.step_ms()[DP2_WARM:]
    losses = [float(v) for v in clock.losses]
    split = [bn_act.fwd_split_launches, bn_act.bwd_split_launches]
    net.set_listeners()
    bn_act.fwd_split_launches = bn_act.bwd_split_launches = 0
    spent, undo = _count_collectives(torch)
    try:
        ct.fit(batches)
    finally:
        undo()
    report["bfloat16"] = {"losses": losses, "step_ms": steps,
                          "split_launches": split,
                          "split_launches_timed": [bn_act.fwd_split_launches,
                                                   bn_act.bwd_split_launches],
                          "collective_ms_per_step": 1e3 * sum(spent),
                          "collectives_per_step": len(spent)}
    with open(os.path.join(workdir, f"dp2_rank{rank}.json"), "w") as f:
        json.dump(report, f)
    import torch.distributed as dist
    dist.barrier()
    dist.destroy_process_group()


def _run_record_tensors(net) -> dict:
    """Every parameter and running-statistics tensor of a network, by path."""
    from deeplearning4j_tpu_torch.parallel.compress import _leaves
    return {f"{kind}:{p}": t.detach() for kind, tree in (("params", net.params),
                                                         ("state", net.state))
            for p, t in _leaves(tree)}


DP2_WORKER = r'''
import sys
sys.path.insert(0, {root!r})
import chip_smoke
chip_smoke.dp2_rank(int(sys.argv[1]), int(sys.argv[2]), {workdir!r})
'''


def data_parallel_world2_phase(torch, dev, card, workdir) -> dict:
    """ResNet50 (the training phase's, full width) through ClusterTrainer.fit
    in two processes on the one card, a gloo group of two (gloo all-reduces
    CUDA tensors through host copies; NCCL refuses two ranks on one device),
    64 rows a rank of global batches of 128: the bn wrappers take the split
    launches at world 2, the statistics and the gradient sums going over
    the ranks.
    1. Each rank's split bn outputs at res2 (bf16, +res) and res4 (float32,
       leakyrelu, +res) shapes held against the plain versions on the
       concatenated global batch (hold_bn_fwd / hold_bn_bwd).
    2. Float32, cudnn.deterministic, Sgd DP2_LR, DP2_STEPS steps: the
       world-2 run and ComputationGraph.fit on the global batch in this
       process both held to a float64 referee (the unfused graph, same
       parameters, fit): the whole parameter update of the world-2 run,
       and its worst leaf, within DP2_REFEREE_FACTOR times fit's own
       distances from it, each loss within DP2_LOSS_RTOL of its and the
       first within DP2_FIRST_LOSS_RTOL; both ranks end with one state_sha. The same steps with each rank's own
       batch statistics (the negative control) must break a limit.
    3. bf16 (Adam 1e-3, as the training phase): step ms at world 2 against
       fit's in this process, and one step with each collective timed after
       a device sync (gloo's share of the step).
    53 split forward and 53 split backward calls a step on each rank, and
    in float32 2 x 53 + 1 all-reduces a step (one a fused block and
    direction, one gradient bucket)."""
    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph

    t_phase = time.perf_counter()
    flags = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    runs = {}
    try:
        for name in ("fit", "referee"):
            unfused, fused = _dp2_float32_nets(dev, "float64" if name == "referee" else
                                               "float32")
            net = unfused if name == "referee" else fused
            p0 = {k: v.clone() for k, v in _run_record_tensors(fused).items()}
            del unfused, fused
            clock = _StepClock(torch)
            net.set_listeners(clock)
            net.fit(_dp2_batches(torch, dev, DP2_STEPS))
            if name == "referee":
                from deeplearning4j_tpu_torch.perf.fusion import fuse_network
                net = fuse_network(net)  # the fused layout, to compare
            runs[name] = {"losses": [float(v) for v in clock.losses],
                          "step_ms": clock.step_ms(),
                          "params": {k: v.clone() for k, v in _run_record_tensors(net).items()}}
            del net
            torch.cuda.empty_cache()
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = flags
    ref_losses, ref_f32_ms = runs["fit"]["losses"], runs["fit"]["step_ms"]
    net = ComputationGraph(resnet50_train_conf(), dev).init()
    clock = _StepClock(torch)
    net.set_listeners(clock)
    net.fit(_dp2_batches(torch, dev, 1), num_epochs=DP2_WARM + DP2_TIMED)
    fit_bf16_ms = clock.step_ms()[DP2_WARM:]
    del net
    torch.cuda.empty_cache()

    prog = DP2_WORKER.format(root=os.path.dirname(os.path.abspath(__file__)), workdir=workdir)
    port = _free_port()
    t0 = time.perf_counter()
    logs = [open(os.path.join(workdir, f"dp2_rank{r}.log"), "w") for r in (0, 1)]
    procs = [subprocess.Popen([sys.executable, "-c", prog, str(r), str(port)], stdout=logs[r],
                              stderr=subprocess.STDOUT) for r in (0, 1)]
    try:
        rcs = [p.wait(timeout=600) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in logs:
            f.close()
    workers_s = time.perf_counter() - t0
    if any(rcs):
        tails = [open(os.path.join(workdir, f"dp2_rank{r}.log")).read()[-3000:] for r in (0, 1)]
        raise AssertionError(f"data_parallel_world2: workers exited {rcs}:\n" + "\n".join(tails))
    reps = [json.load(open(os.path.join(workdir, f"dp2_rank{r}.json"))) for r in (0, 1)]
    f32 = [r["float32"] for r in reps]
    if f32[0]["state_sha"] != f32[1]["state_sha"]:
        raise AssertionError("data_parallel_world2: the ranks' state_sha differ")
    got = torch.load(os.path.join(workdir, "dp2_float32.pt"))
    control = torch.load(os.path.join(workdir, "dp2_control.pt"))
    referee = runs["referee"]

    def loss_err(losses, want):
        return max(abs(a - b) / abs(b) for a, b in zip(losses, want))

    def update_err(params, want):
        """|params - want's| over |want's update|, all tensors as one vector."""
        num = sum(float((params[k].to(dev) - want[k]).double().norm()) ** 2 for k in want)
        den = sum(float((want[k] - p0[k]).double().norm()) ** 2 for k in want)
        return (num / den) ** 0.5

    def leaf_err(params, want):
        """The worst leaf's |params - want's| over |want's update|, and its path."""
        worst = (0.0, None)
        for k in want:
            num = float((params[k].to(dev) - want[k]).double().norm())
            den = float((want[k] - p0[k]).double().norm())
            e = num / den if den else (float("inf") if num else 0.0)
            if e > worst[0]:
                worst = (e, k)
        return worst

    errs, worst_leaf = {}, {}
    for run, losses, params in (("world2", f32[0]["losses"], got),
                                ("fit", ref_losses, runs["fit"]["params"]),
                                ("control", reps[0]["control"]["losses"], control)):
        worst_leaf[run] = leaf_err(params, referee["params"])
        errs[run] = {"loss": loss_err(losses, referee["losses"]),
                     "first_loss": loss_err(losses[:1], referee["losses"]),
                     "update": update_err(params, referee["params"]),
                     "leaf": worst_leaf[run][0]}
    limits = {"loss": DP2_LOSS_RTOL, "first_loss": DP2_FIRST_LOSS_RTOL,
              "update": DP2_REFEREE_FACTOR * errs["fit"]["update"],
              "leaf": DP2_REFEREE_FACTOR * errs["fit"]["leaf"]}
    between = {"loss": loss_err(f32[0]["losses"], ref_losses),
               "update": update_err(got, runs["fit"]["params"])}
    rejects = {k: errs["control"][k] > limits[k] for k in limits}
    if len(f32[0]["losses"]) != DP2_STEPS or any(errs["world2"][k] > limits[k] for k in limits):
        raise AssertionError(f"data_parallel_world2: losses {f32[0]['losses']} at world 2, "
                             f"{ref_losses} through fit, {referee['losses']} the float64 "
                             f"referee; distances from the referee {errs} (worst leaves "
                             f"{worst_leaf}), limits {limits}")
    if not any(rejects.values()):
        raise AssertionError(f"data_parallel_world2: the limits {limits} admit the per-rank "
                             f"statistics control {errs['control']}")
    launches = {"fwd": 0, "bwd": 0}
    for r in reps:
        steps = DP2_STEPS
        split = r["float32"]["split_launches"]
        if split != [RESNET50_FUSED_BLOCKS * steps] * 2 or r["float32"]["launches"] != split:
            raise AssertionError(f"data_parallel_world2: rank {r['rank']} made {split} split "
                                 f"calls in {steps} steps; want 53 each a step")
        # one all-reduce a fused block and direction, and the gradient bucket
        if r["float32"]["all_reduces"] != steps * (2 * RESNET50_FUSED_BLOCKS + 1):
            raise AssertionError(f"data_parallel_world2: rank {r['rank']} took "
                                 f"{r['float32']['all_reduces']} all-reduces in {steps} "
                                 f"float32 steps; want {2 * RESNET50_FUSED_BLOCKS + 1} a step")
        bsplit = r["bfloat16"]["split_launches"]
        timed = r["bfloat16"]["split_launches_timed"]
        if (bsplit != [RESNET50_FUSED_BLOCKS * (DP2_WARM + DP2_TIMED)] * 2
                or timed != [RESNET50_FUSED_BLOCKS] * 2):
            raise AssertionError(f"data_parallel_world2: rank {r['rank']} made {bsplit} bf16 "
                                 f"split calls, then {timed} in the collective-timed step")
        launches["fwd"] += split[0] + bsplit[0] + timed[0]
        launches["bwd"] += split[1] + bsplit[1] + timed[1]
    step_w2 = float(np.median(reps[0]["bfloat16"]["step_ms"]))
    out = {"card": card, "world": 2, "backend": "gloo", "rows_per_rank": TRAIN_BATCH // 2,
           "float32": {"steps": DP2_STEPS, "losses_world2": f32[0]["losses"],
                       "losses_fit": ref_losses, "losses_float64": referee["losses"],
                       "from_referee": errs, "worst_leaf": worst_leaf, "limits": limits,
                       "control_rejected_by": rejects,
                       "losses_control": reps[0]["control"]["losses"],
                       "world2_from_fit": between,
                       "step_ms_float64_referee": referee["step_ms"],
                       "state_sha_equal": True, "step_ms_world2": f32[0]["step_ms"],
                       "step_ms_fit": ref_f32_ms,
                       "all_reduces": f32[0]["all_reduces"]},
           "bfloat16": {"step_ms_world2": step_w2,
                        "step_ms_world2_rank1": float(np.median(reps[1]["bfloat16"]["step_ms"])),
                        "step_ms_fit": float(np.median(fit_bf16_ms)),
                        "collective_ms_per_step": reps[0]["bfloat16"]["collective_ms_per_step"],
                        "collectives_per_step": reps[0]["bfloat16"]["collectives_per_step"],
                        "gloo_share_of_step": reps[0]["bfloat16"]["collective_ms_per_step"]
                        / step_w2, "losses": reps[0]["bfloat16"]["losses"]},
           "bn_check": {f"rank{r['rank']}": r["bn_check"] for r in reps},
           "split_launches_per_rank": {"float32": f32[0]["split_launches"],
                                       "bfloat16": reps[0]["bfloat16"]["split_launches"],
                                       "bfloat16_timed":
                                           reps[0]["bfloat16"]["split_launches_timed"]},
           "workers_s": workers_s, "seconds": time.perf_counter() - t_phase}
    print("data_parallel_world2 " + json.dumps(out), flush=True)
    return launches


def _split_v1(name, argtypes):
    """The C entry bn_act_split_v1_<name> of the split launches' first
    design (csrc/bn_act_split_v1.cu)."""
    import ctypes

    from deeplearning4j_tpu_torch.perf.kernels import _build
    fn = getattr(_build.load("bn_act_split_v1"), f"bn_act_split_v1_{name}")
    fn.argtypes = list(argtypes)
    fn.restype = ctypes.c_longlong if name.endswith("scratch") else ctypes.c_int
    return fn


def first_design_split_fwd(torch, act, z, gamma, beta, res):
    """The split forward's first design at world 1 on the same operands, as
    its wrapper ran it: bf16/f16 one statistics launch (S and Q), float32
    two (S, then the centred Q with the global mean), each row count a
    torch.full, then the apply launch (entries: the launches' ms keys)."""
    import ctypes
    P, I, L, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
    from deeplearning4j_tpu_torch.perf.kernels import bn_act
    c = z.shape[-1]
    n = z.numel() // c
    codes = (bn_act._DTYPES[z.dtype], bn_act.KERNEL_ACTS[act], int(res is not None))
    vec = bn_act._vec(z, res)
    stream = torch.cuda.current_stream().cuda_stream

    def sums(pass_, gsum=None, gn=None):
        need = _split_v1("fwd_sums_scratch", [I, I, I, I, L, I, I])(*codes, pass_, n, c, vec)
        scratch = torch.empty(need, dtype=torch.float32, device=z.device)
        lsum = torch.empty(2 * c if pass_ == 0 else c, dtype=torch.float32, device=z.device)
        err = _split_v1("fwd_sums_launch", [I, I, I, I, P, L, I, P, P, P, P, L, I, P])(
            *codes, pass_, z.data_ptr(), n, c, None if gsum is None else gsum.data_ptr(),
            None if gn is None else gn.data_ptr(), lsum.data_ptr(), scratch.data_ptr(), need,
            vec, stream)
        if err:
            raise RuntimeError(f"bn_act_split_v1 fwd sums failed with CUDA error {err}")
        return lsum

    def count():
        return torch.full((1,), float(n), dtype=torch.float32, device=z.device)

    if z.dtype == torch.float32:
        gsum = sums(1)
        gn = count()
        gsq = sums(2, gsum, gn)
        count()
    else:
        sq = sums(0)
        gsum, gsq, gn = sq[:c], sq[c:], count()
    out = torch.empty_like(z)
    mean, var, inv = torch.empty((3, c), dtype=torch.float32, device=z.device)
    err = _split_v1("fwd_apply_launch", [I, I, P, P, P, P, L, I, F, P, P, P, P, P, P, P, I, P])(
        *codes[:2], z.data_ptr(), gamma.data_ptr(), beta.data_ptr(),
        None if res is None else res.data_ptr(), n, c, BN_EPS, gsum.data_ptr(), gsq.data_ptr(),
        gn.data_ptr(), out.data_ptr(), mean.data_ptr(), var.data_ptr(), inv.data_ptr(),
        bn_act._vec(z, res, out), stream)
    if err:
        raise RuntimeError(f"bn_act_split_v1 fwd apply failed with CUDA error {err}")
    return out, mean, var, inv


def first_design_split_bwd(torch, act, z, gamma, beta, res, mean, inv, dout):
    """The split backward's first design at world 1 on the same operands,
    as its wrapper ran it: the sums launch, the row count a torch.full, the
    dz launch (which recomputes dpre from dout and res)."""
    import ctypes
    P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    from deeplearning4j_tpu_torch.perf.kernels import bn_act
    c = z.shape[-1]
    n = z.numel() // c
    dt, ac = bn_act._DTYPES[z.dtype], bn_act.KERNEL_ACTS[act]
    ptr = (lambda t: None if t is None else t.data_ptr())
    dpre = None if res is None else torch.empty_like(z)
    vec = bn_act._vec(z, res, dout, dpre)
    stream = torch.cuda.current_stream().cuda_stream
    need = _split_v1("bwd_sums_scratch", [I, I, I, L, I, I])(dt, ac, int(res is not None), n,
                                                              c, vec)
    scratch = torch.empty(need, dtype=torch.float32, device=z.device)
    dg, db = torch.empty((2, c), dtype=torch.float32, device=z.device)
    err = _split_v1("bwd_sums_launch", [I, I, P, P, P, P, P, P, P, L, I, P, P, P, P, L, I, P])(
        dt, ac, z.data_ptr(), gamma.data_ptr(), beta.data_ptr(), ptr(res), mean.data_ptr(),
        inv.data_ptr(), dout.data_ptr(), n, c, dg.data_ptr(), db.data_ptr(), ptr(dpre),
        scratch.data_ptr(), need, vec, stream)
    gn = torch.full((1,), float(n), dtype=torch.float32, device=z.device)
    dz = torch.empty_like(z)
    if not err:
        err = _split_v1("bwd_dz_launch", [I, I, P, P, P, P, P, P, P, L, I, P, P, P, P, I, P])(
            dt, ac, z.data_ptr(), gamma.data_ptr(), beta.data_ptr(), ptr(res), mean.data_ptr(),
            inv.data_ptr(), dout.data_ptr(), n, c, dg.data_ptr(), db.data_ptr(), gn.data_ptr(),
            dz.data_ptr(), vec, stream)
    if err:
        raise RuntimeError(f"bn_act_split_v1 bwd failed with CUDA error {err}")
    return dz, dg, db, dpre


def split_floor(n, c, esize, residual, kind):
    """(ms) of the bytes the split's design must move at the card's peak:
    the forward reads z twice (the statistics launch, then the apply),
    res once and writes out; the backward reads z, dout (and res, writing
    dpre) in the sums launch, then z and dpre (or dout) and writes dz."""
    tensors = (4 if residual else 3) if kind == "fwd" else (7 if residual else 5)
    return 1e3 * (tensors * n * c * esize + 6 * 4 * c) / PEAK_BYTES_PER_S


def _hold_partials(torch, label, z, got):
    """The float32 statistics launch's row (K, S', Q', n) against
    bn_fwd_partials_plain's on the same z: K and n exact, S' within n
    2^-53 sum |z - K| and Q' within n 2^-53 Q' (the worst-case roundoff of
    an n-term double sum; both orders are sums of the same doubles)."""
    from deeplearning4j_tpu_torch.perf.kernels import bn_act
    c = z.shape[-1]
    n = z.numel() // c
    want = bn_act.bn_fwd_partials_plain(z)
    if not (torch.equal(got[0, :c], want[0, :c]) and float(got[0, -1]) == n):
        raise AssertionError(f"split {label}: the statistics launch's K or n differs")
    spread = (z.double() - want[0, :c]).abs().sum(dim=0)
    tol = n * 2.0 ** -53
    s_err = (got[0, c:2 * c] - want[0, c:2 * c]).abs()
    q_err = (got[0, 2 * c:3 * c] - want[0, 2 * c:3 * c]).abs()
    _hold(f"split {label} S'", s_err <= tol * spread, float(s_err.max()))
    _hold(f"split {label} Q'", q_err <= tol * want[0, 2 * c:3 * c], float(q_err.max()))
    return {"s_err_of_bound": float((s_err / (tol * spread).clamp_min(1e-300)).max()),
            "q_err_of_bound": float((q_err / (tol * want[0, 2 * c:3 * c]).clamp_min(1e-300)).max())}


def _split_times(torch, dev, flush, case, n, c, dtype_name, act, residual) -> dict:
    """The split launches against the one launch at one shape, at world 1:
    both directions bitwise the one launch in every dtype; float32's
    statistics launch held to bn_fwd_partials_plain (_hold_partials) and the
    apply's mean and var bitwise combine_rank_partials of its output; out
    and dz held to the plain versions (hold_bn_fwd, hold_bn_bwd). Timed: the
    split calls ("ms"), each launch ("entries"), the first design
    (csrc/bn_act_split_v1.cu, "previous_ms"), the one launch
    ("one_launch_ms"), the plain versions, F.batch_norm + act and
    SyncBatchNorm's primitives, beside the bound (each tensor once) and the
    split's floor (z read twice, split_floor)."""
    from deeplearning4j_tpu_torch.perf.kernels import bn_act

    (z, gamma, beta, res), one, dout = bn_operands(torch, dev, n, c, dtype_name, act,
                                                   residual)
    label = f"split {case} {n}x{c} {dtype_name} {act}{' +res' if residual else ''}"
    args = (act, BN_EPS, z, gamma, beta, res)
    spl = bn_act.bn_act_fwd_split(*args)
    bargs = (act, BN_EPS, z, gamma, beta, res, one[1], one[3], dout)
    bone, bspl = bn_act.bn_act_bwd(*bargs), bn_act.bn_act_bwd_split(*bargs)
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(one, spl)):
        raise AssertionError(f"{label}: the split forward differs from the one launch")
    if not all((a is None and b is None) or torch.equal(a, b) for a, b in zip(bone, bspl)):
        raise AssertionError(f"{label}: the split backward differs from the one launch")
    held = hold_bn_fwd(torch, label, (z, gamma, beta, res), act, spl,
                       bn_act.bn_act_fwd_plain(*args))
    bwd_err = hold_bn_bwd(torch, label, bspl, bn_act.bn_act_bwd_plain(*bargs))
    has_res = res is not None
    stats = bn_act.bn_fwd_sums(act, z, has_res)
    row = {"case": case, "rows": n, "channels": c, "dtype": dtype_name, "act": act,
           "residual": residual, "bitwise_vs_one_launch": "forward and backward"}
    if dtype_name == "float32":
        row["partials"] = _hold_partials(torch, label, z, stats)
        mean, var = bn_act.combine_rank_partials(stats)
        if not (torch.equal(mean, spl[1]) and torch.equal(var, spl[2])):
            raise AssertionError(f"{label}: the apply's statistics differ from "
                                 "combine_rank_partials of the statistics launch's")
    dgamma, dbeta, dpre, sums = bn_act.bn_bwd_sums(act, z, gamma, beta, res, one[1], one[3],
                                                   dout)
    v1 = (first_design_split_fwd(torch, act, z, gamma, beta, res),
          first_design_split_bwd(torch, *bargs[:1], *bargs[2:]))
    torch.cuda.synchronize()
    row["v1_max_abs_diff"] = {"fwd": _max_err(v1[0][0], spl[0]),
                              "bwd": _max_err(v1[1][0], bspl[0])}
    del v1
    row["entries"] = {
        "fwd_sums_ms": time_ms(torch, lambda: bn_act.bn_fwd_sums(act, z, has_res), flush),
        "fwd_apply_ms": time_ms(torch, lambda: bn_act.bn_fwd_apply(
            act, BN_EPS, z, gamma, beta, res, stats), flush),
        "bwd_sums_ms": time_ms(torch, lambda: bn_act.bn_bwd_sums(
            act, z, gamma, beta, res, one[1], one[3], dout), flush),
        "bwd_dz_ms": time_ms(torch, lambda: bn_act.bn_bwd_dz(
            act, z, gamma, beta, res, one[1], one[3], dout, dpre, sums), flush)}
    lib = _bn_library_ms(torch, flush, z, gamma, beta, res, act, dout)
    row["library"] = lib["note"]
    esize = z.element_size()
    for kind, split_fn, v1_fn, one_fn, plain_fn, tensors, err in (
            ("fwd", lambda: bn_act.bn_act_fwd_split(*args),
             lambda: first_design_split_fwd(torch, act, z, gamma, beta, res),
             lambda: bn_act.bn_act_fwd(*args), lambda: bn_act.bn_act_fwd_plain(*args),
             3 if residual else 2, held["max_abs_err"]),
            ("bwd", lambda: bn_act.bn_act_bwd_split(*bargs),
             lambda: first_design_split_bwd(torch, *bargs[:1], *bargs[2:]),
             lambda: bn_act.bn_act_bwd(*bargs), lambda: bn_act.bn_act_bwd_plain(*bargs),
             5 if residual else 3, bwd_err)):
        bound_ms, bound_by = bn_bound(n, c, esize, tensors, BN_OPS_PER_ELT[kind])
        # parent, change, change, parent: the first design and the redesign in turns
        v1_ms = [time_ms(torch, v1_fn, flush)]
        ms = [time_ms(torch, split_fn, flush), time_ms(torch, split_fn, flush)]
        v1_ms.append(time_ms(torch, v1_fn, flush))
        row[kind] = {"ms": float(np.median(ms)), "ms_runs": ms, "host_ms": host_ms(torch, split_fn),
                     "previous_ms": float(np.median(v1_ms)), "previous_ms_runs": v1_ms,
                     "one_launch_ms": time_ms(torch, one_fn, flush),
                     "plain_ms": time_ms(torch, plain_fn, flush), "bound_ms": bound_ms,
                     "bound_by": bound_by,
                     "floor_ms": split_floor(n, c, esize, residual, kind),
                     "library_ms": lib[kind], "sync_library_ms": lib["sync_" + kind],
                     "max_abs_err": err}
    print("bn_split " + json.dumps(row), flush=True)
    return row


def _ring_check(torch, dev, flush) -> dict:
    """ring_self_attention and ulysses_self_attention at one rank at the
    LM's causal float32 shape against reference_attention and the flash
    kernel (within RING_LIMIT of max |v|), the ring's and Ulysses'
    gradients against the reference's (RING_GRAD_LIMIT of each gradient's
    largest magnitude), each timed."""
    from deeplearning4j_tpu_torch.parallel import (flash_self_attention, reference_attention,
                                                   ring_self_attention, ulysses_self_attention)

    gen = torch.Generator(device=dev)
    gen.manual_seed(191)
    q, k, v = (torch.randn(RING_SHAPE, generator=gen, device=dev) for _ in range(3))
    g = torch.randn(RING_SHAPE, generator=gen, device=dev)
    vmax = float(v.abs().max())
    ref = reference_attention(q, k, v, causal=True)
    flash = flash_self_attention(q, k, v, causal=True)
    out = {"shape": list(RING_SHAPE), "causal": True, "dtype": "float32",
           "limit_of_max_v": RING_LIMIT}
    for name, fn in (("ring", ring_self_attention), ("ulysses", ulysses_self_attention)):
        got = fn(q, k, v, causal=True)
        errs = {"vs_reference": _max_err(got, ref), "vs_flash": _max_err(got, flash)}
        if max(errs.values()) > RING_LIMIT * vmax:
            raise AssertionError(f"model_parallel: {name} {errs} against a limit of "
                                 f"{RING_LIMIT * vmax}")
        leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
        grads = torch.autograd.grad(fn(*leaves, causal=True), leaves, g)
        rleaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
        rgrads = torch.autograd.grad(reference_attention(*rleaves, causal=True), rleaves, g)
        gerr = max(_max_err(a, b) / float(b.abs().max()) for a, b in zip(grads, rgrads))
        if gerr > RING_GRAD_LIMIT:
            raise AssertionError(f"model_parallel: {name} gradients {gerr} of the largest "
                                 "magnitude from the reference's")
        del leaves, grads, rleaves, rgrads
        out[name] = dict(errs, grad_err_of_max=gerr, ms=time_ms(
            torch, lambda fn=fn: fn(q, k, v, causal=True), flush, reps=5, warm=1))
    out["reference_ms"] = time_ms(torch, lambda: reference_attention(q, k, v, causal=True),
                                  flush, reps=5, warm=1)
    out["flash_ms"] = time_ms(torch, lambda: flash_self_attention(q, k, v, causal=True), flush,
                              reps=5, warm=1)
    return out


def _gpipe_check(torch, dev) -> dict:
    """GPipeTrainer at one stage on a stack of GPIPE_BLOCKS residual MLP
    blocks of GPT-2 small's widths (d -> 4d -> d, GELU), GPIPE_STEPS Sgd
    steps on GPIPE_M microbatches, against the same steps of the sequential
    stack under autograd: the outputs bitwise, the losses within rtol 1e-6
    and every parameter within GPIPE_PARAM_TOL of its largest magnitude."""
    import torch.nn.functional as F

    from deeplearning4j_tpu_torch.optimize.updaters import Sgd
    from deeplearning4j_tpu_torch.parallel import (GPipeTrainer, make_pipeline_mesh,
                                                   pipeline_apply)

    gen = torch.Generator(device=dev)
    gen.manual_seed(192)
    L, d, f = GPIPE_BLOCKS, GPIPE_D, GPIPE_F

    def draw(*shape, scale):
        return torch.randn(shape, generator=gen, device=dev) * scale

    # GPT-2's initialisation: the residual branch's projection scaled by
    # 1/sqrt(2 L), so the stack starts near the identity; the target, half
    # the input, is learnable
    stacked = {"W1": draw(1, L, d, f, scale=0.02), "b1": draw(1, L, f, scale=0.02),
               "W2": draw(1, L, f, d, scale=0.02 / (2 * L) ** 0.5),
               "b2": draw(1, L, d, scale=0.02)}
    xs = draw(GPIPE_M, GPIPE_MB, d, scale=1.0)
    ys = 0.5 * xs

    def block_fn(p, x):
        for i in range(L):
            x = x + F.gelu(x @ p["W1"][i] + p["b1"][i]) @ p["W2"][i] + p["b2"][i]
        return x

    def loss_fn(pred, y):
        return torch.mean((pred - y) ** 2)

    mesh = make_pipeline_mesh(1, device=dev)
    tr = GPipeTrainer(block_fn, loss_fn, Sgd(GPIPE_LR), mesh)
    params = tr.place(stacked)
    fwd = pipeline_apply(block_fn, params, xs, mesh)
    seq_fwd = torch.stack([block_fn({k: a[0] for k, a in params.items()}, x) for x in xs])
    if not torch.equal(fwd, seq_fwd):
        raise AssertionError("model_parallel: GPipe's one-stage output differs from the "
                             "sequential stack's")
    opt = tr.init_opt(params)
    upd = Sgd(GPIPE_LR)
    seq = {k: a.clone() for k, a in params.items()}
    seq_opt = upd.init_state(seq)
    losses, seq_losses, step_ms = [], [], []
    for _ in range(GPIPE_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, opt, loss = tr.step(params, opt, xs, ys)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        leaves = {k: a.detach().requires_grad_(True) for k, a in seq.items()}
        sl = torch.stack([loss_fn(block_fn({k: a[0] for k, a in leaves.items()}, x), y)
                          for x, y in zip(xs, ys)]).mean()
        grads = dict(zip(leaves, torch.autograd.grad(sl, list(leaves.values()))))
        ups, seq_opt = upd.update(grads, seq_opt)
        seq = {k: (seq[k] + ups[k]).detach() for k in seq}
        losses.append(float(loss))
        seq_losses.append(float(sl.detach()))
    loss_err = max(abs(a - b) / abs(b) for a, b in zip(losses, seq_losses))
    perr = max(_max_err(params[k], seq[k]) / float(seq[k].abs().max()) for k in seq)
    if loss_err > 1e-6 or perr > GPIPE_PARAM_TOL or not losses[-1] < losses[0]:
        raise AssertionError(f"model_parallel: GPipe losses {losses} against {seq_losses}, "
                             f"parameters {perr} of their largest magnitude")
    return {"stages": 1, "blocks": L, "widths": [d, f, d], "microbatches": GPIPE_M,
            "rows_per_microbatch": GPIPE_MB, "steps": GPIPE_STEPS, "losses": losses,
            "loss_max_rel_err": loss_err, "param_max_err_of_max": perr,
            "param_limit": GPIPE_PARAM_TOL, "forward_bitwise": True,
            "step_ms": float(np.median(step_ms))}


def model_parallel_phase(torch, dev, card, flush) -> tuple:
    """Model and sequence parallelism at one rank, in an NCCL group of one
    that the phase starts (one card: NCCL refuses two ranks on one device;
    across ranks they are tested on the CPU over gloo):
    1. ResNet50 (bf16, fused, Adam, cudnn.deterministic) through
       ParallelWrapper(tensor_parallel=True) on a (1, 1) mesh, MP_STEPS
       batches of 128: parameters, running stats, Adam state and state_sha
       bitwise ComputationGraph.fit's; 53 + 53 bn launches a step (the one
       launch at world 1);
    2. ring_self_attention and ulysses_self_attention (_ring_check);
    3. GPipeTrainer at one stage (_gpipe_check);
    4. the split bn launches against the one launch and their first
       design at SPLIT_CASES (_split_times).
    Returns the bn launches of step 1 and the split rows."""
    import torch.distributed as dist

    from deeplearning4j_tpu_torch.checkpoint.sharded import state_sha
    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
    from deeplearning4j_tpu_torch.parallel import ParallelWrapper, make_mesh
    from deeplearning4j_tpu_torch.perf.kernels import bn_act

    t_phase = time.perf_counter()
    conf = resnet50_train_conf()
    batches = ckpt_batches(torch, dev)[:MP_STEPS]
    out = {"card": card}
    flags = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{_free_port()}",
                            world_size=1, rank=0)
    try:
        net = ComputationGraph(conf, dev).init()
        net.fit(batches)
        ref, ref_sha = _run_record(net), state_sha(net)
        del net
        torch.cuda.empty_cache()
        net = ComputationGraph(conf, dev).init()
        clock = _StepClock(torch)
        net.set_listeners(clock)
        pw = ParallelWrapper(net, mesh=make_mesh(tp=1, device=dev), tensor_parallel=True)
        bn_act.fwd_launches = bn_act.bwd_launches = 0
        pw.fit(batches)
        launches = {"fwd": bn_act.fwd_launches, "bwd": bn_act.bwd_launches}
        diff = _differences(ref, _run_record(net))
        if diff or state_sha(net) != ref_sha:
            raise AssertionError(f"model_parallel: ParallelWrapper(tensor_parallel=True) "
                                 f"differs from fit in {len(diff)} arrays: {diff[:8]}")
        if not launches["fwd"] == launches["bwd"] == RESNET50_FUSED_BLOCKS * MP_STEPS:
            raise AssertionError(f"model_parallel: bn launches {launches} in {MP_STEPS} steps")
        out["tensor_parallel"] = {"mesh": pw.mesh.shape, "steps": MP_STEPS,
                                  "bitwise_vs_fit": True, "compared_arrays": len(ref["arrays"]),
                                  "step_ms": float(np.median(clock.step_ms()[1:])),
                                  "bn_act_launches": launches}
        del net, pw
        torch.cuda.empty_cache()
        out["sequence_parallel"] = _ring_check(torch, dev, flush)
        torch.cuda.empty_cache()
        out["gpipe"] = _gpipe_check(torch, dev)
        torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = flags
    rows = [_split_times(torch, dev, flush, *case) for case in SPLIT_CASES]
    torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t_phase
    print("model_parallel " + json.dumps(out), flush=True)
    return launches, rows


FLEET_REPLICA = r'''
import json, os, signal, sys, threading
sys.path.insert(0, {root!r})
from deeplearning4j_tpu_torch.fleet.replica import restore_and_serve
from deeplearning4j_tpu_torch.perf.kernels import int4_dot

rid = sys.argv[1]
report = os.path.join({workdir!r}, rid + ".json")
done = threading.Event()
signal.signal(signal.SIGTERM, lambda *a: done.set())


def write():
    with open(report + ".tmp", "w") as f:
        json.dump({{"int4_dot": int4_dot.launches}}, f)
    os.replace(report + ".tmp", report)


rep = restore_and_serve({store!r}, [("vgg16", {ckpt!r})], replica_id=rid, ttl_s={ttl},
                        weight_bits=4, batch_limit={batch_limit},
                        default_deadline_ms={deadline}, wait_ready_s=600)
print("ready", rid, rep.address, flush=True)
while not done.wait(0.1):
    write()
rep.stop(drain_timeout_s=30)
write()
'''


def fleet_phase(torch, dev, card, net, rec, workdir) -> dict:
    """Two replicas of the serving fleet, each a restore_and_serve
    subprocess on the card, serve the int4 VGG16 of the model_server phase
    (its float32 weights and calibration record in one checkpoint, served
    with 4-bit weights) behind a FleetRouter in this process:
    1. a burst of predicts (FLEET_CLIENTS client threads, each cycling
       through FLEET_REQUESTS bodies of 1-4 rows, float32 b64 frames)
       through the router; one replica is SIGKILLed after FLEET_KILL_AFTER
       answers, and the burst goes on FLEET_AFTER_S past its lease's
       lapse. Every answer's body equals, byte for byte, the body the
       surviving replica gives the same request directly; some answers
       after the lapse and none of them but a 200 (typed sheds before,
       counted);
    2. FLEET_HOPS one-row predicts routed and direct, one at a time: the
       router hop's p50 overhead;
    3. each replica's int4_dot launches (its report file, written every 0.1
       s; the killed one's up to its last write)."""
    import signal

    from deeplearning4j_tpu_torch.checkpoint import CheckpointManager
    from deeplearning4j_tpu_torch.fleet import FleetRouter, FleetView
    from deeplearning4j_tpu_torch.serving.wire import encode_array

    t_phase = time.perf_counter()
    ckpt, store = os.path.join(workdir, "vgg16_ckpt"), os.path.join(workdir, "leases")
    os.makedirs(store)
    net._quant_calibration = rec
    try:
        CheckpointManager(ckpt, async_write=False, device=dev).save(net)
    finally:
        del net._quant_calibration
    prog = FLEET_REPLICA.format(root=os.path.dirname(os.path.abspath(__file__)),
                                workdir=workdir, store=store, ckpt=ckpt, ttl=FLEET_TTL_S,
                                batch_limit=MS_BATCH_LIMIT, deadline=MS_DEADLINE_MS)
    rids = ["rep0", "rep1"]
    logs = {r: open(os.path.join(workdir, f"{r}.log"), "w") for r in rids}
    t0 = time.perf_counter()
    procs = {r: subprocess.Popen([sys.executable, "-c", prog, r], stdout=logs[r],
                                 stderr=subprocess.STDOUT) for r in rids}
    router = FleetRouter(FleetView(store, ttl_s=FLEET_TTL_S), refresh_s=0.1, seed=0,
                         request_timeout_s=120).start()
    out = {"card": card, "replicas": len(rids), "weight_bits": 4, "ttl_s": FLEET_TTL_S}
    try:
        def tails():
            return "\n".join(open(os.path.join(workdir, f"{r}.log")).read()[-2000:]
                             for r in rids)

        deadline = time.monotonic() + 300
        while len(router.table()) < len(rids):
            if time.monotonic() > deadline or any(p.poll() is not None for p in procs.values()):
                raise AssertionError("fleet: the replicas did not become ready:\n" + tails())
            time.sleep(0.1)
        out["replicas_ready_s"] = time.perf_counter() - t0
        table = router.table()
        direct = {r: table[r].address for r in rids}
        rng = np.random.default_rng(19)
        bodies = [encode_array(rng.standard_normal((int(rng.integers(1, 5)), VGG_SIDE,
                                                    VGG_SIDE, 3), dtype=np.float32))
                  for _ in range(FLEET_CLIENTS * FLEET_REQUESTS)]
        answers, lock = [], threading.Lock()
        killed = {}

        def client(cid):
            # each client cycles through its bodies until the killed
            # replica's lease has been lapsed FLEET_AFTER_S
            i = 0
            while True:
                with lock:
                    done = ("at" in killed and i >= FLEET_REQUESTS and time.perf_counter()
                            > killed["at"] + FLEET_TTL_S + FLEET_AFTER_S)
                if done or i >= 50 * FLEET_REQUESTS:
                    return
                j = cid * FLEET_REQUESTS + i % FLEET_REQUESTS
                data = json.dumps(bodies[j]).encode()
                t = time.perf_counter()
                code, raw = _raw_post(router.address, "/v1/models/vgg16:predict", data)
                with lock:
                    answers.append((j, code, raw, t, time.perf_counter()))
                    if len(answers) == FLEET_KILL_AFTER and not killed:
                        procs["rep1"].send_signal(signal.SIGKILL)
                        killed["at"] = time.perf_counter()
                i += 1

        threads = [threading.Thread(target=client, args=(c,)) for c in range(FLEET_CLIENTS)]
        t_burst = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        burst_s = time.perf_counter() - t_burst
        if not killed or any(t.is_alive() for t in threads):
            raise AssertionError(f"fleet: {len(answers)} answers, killed {killed}")
        procs["rep1"].wait(timeout=60)
        lapsed = killed["at"] + FLEET_TTL_S
        after = [code for _, code, _, t, _ in answers if t >= lapsed]
        before = [code for _, code, _, t, _ in answers if t < lapsed]
        if not after or any(code != 200 for code in after):
            raise AssertionError(f"fleet: answers after the lease lapsed {after}")
        if any(code not in (200, 429, 503) for code in before):
            raise AssertionError(f"fleet: answers during the lease's lapse {before}")
        # every routed answer byte for byte the survivor's direct answer
        direct_bodies = {}
        for j, code, raw, _, _ in answers:
            if code != 200:
                continue
            if j not in direct_bodies:
                direct_bodies[j] = _raw_post(direct["rep0"], "/v1/models/vgg16:predict",
                                             json.dumps(bodies[j]).encode())
            dcode, draw = direct_bodies[j]
            if dcode != 200 or draw != raw:
                raise AssertionError(f"fleet: request {j}: the routed body differs from the "
                                     f"direct one ({dcode})")
        one = json.dumps(encode_array(rng.standard_normal((1, VGG_SIDE, VGG_SIDE, 3),
                                                          dtype=np.float32))).encode()
        hops = {"routed": [], "direct": []}
        for _ in range(FLEET_HOPS):
            for kind, base in (("routed", router.address), ("direct", direct["rep0"])):
                t = time.perf_counter()
                code, _ = _raw_post(base, "/v1/models/vgg16:predict", one)
                if code != 200:
                    raise AssertionError(f"fleet: a {kind} one-row predict answered {code}")
                hops[kind].append((time.perf_counter() - t) * 1e3)
        lat = [(e - s) * 1e3 for _, code, _, s, e in answers if code == 200]
        out.update(burst={"requests": len(answers), "ok": sum(c == 200 for _, c, _, _, _ in
                                                              answers),
                          "non_200_before_lapse": sum(c != 200 for c in before),
                          "answers_after_lapse": len(after), "wall_s": burst_s,
                          "p50_ms": float(np.median(lat)), "p99_ms": float(np.percentile(lat,
                                                                                          99)),
                          "bodies_equal_direct": True},
                   hop={"routed_p50_ms": float(np.median(hops["routed"])),
                        "direct_p50_ms": float(np.median(hops["direct"])),
                        "overhead_p50_ms": float(np.median(hops["routed"])
                                                 - np.median(hops["direct"]))},
                   router_retries=router._m_retries.value)
    finally:
        router.stop()
        for r, p in procs.items():
            if p.poll() is None:
                p.send_signal(signal.SIGTERM)
        for r, p in procs.items():
            try:
                p.wait(timeout=60)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()
        for f in logs.values():
            f.close()
    launches = {}
    for r in rids:
        path = os.path.join(workdir, f"{r}.json")
        launches[r] = json.load(open(path))["int4_dot"] if os.path.exists(path) else 0
    if launches["rep0"] <= 0:
        raise AssertionError(f"fleet: the surviving replica launched int4_dot {launches}")
    out.update(int4_dot_launches=launches, seconds=time.perf_counter() - t_phase)
    print("fleet " + json.dumps(out), flush=True)
    return sum(launches.values())


def _raw_post(base, path, data, timeout=600):
    """(status, raw body) of one POST."""
    import urllib.error
    import urllib.request

    req = urllib.request.Request(base + path, data=data, method="POST",
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


# ------------------------------------------------- Keras import and the UI
# keras_resnet50: Keras's own ResNet50 (the JSON keras.applications.
# ResNet50(weights=None).to_json() writes, Keras 3.13.1, committed), its
# weights drawn from numpy on KERAS_SEED in Keras's order and shapes,
# imported, fused, and fine-tuned at KERAS_BATCH float32 with a
# StatsListener at frequency 1 (KERAS_STEPS steps), then KERAS_TIMED_STEPS
# steps timed with and without it
KERAS_RESNET50_JSON = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests",
                                   "data", "keras", "resnet50_config.json")
KERAS_SEED = 23
KERAS_BATCH, KERAS_SIDE, KERAS_CLASSES = 32, 224, 1000
KERAS_STEPS, KERAS_TIMED_STEPS = 3, 3
KERAS_EVAL_BATCH = 4
# card against CPU: the eval-mode output within KERAS_OUT_LIMIT of the CPU
# output's largest magnitude (float32 through cuDNN's and oneDNN's
# convolutions), the first step's loss within KERAS_LOSS_RTOL
KERAS_OUT_LIMIT, KERAS_LOSS_RTOL = 1e-4, 1e-4
# listener statistics against numpy on host copies of the same leaves:
# counts, min and max exact; moments within this share of the leaf's
# largest magnitude (a mean near zero rules out a relative limit)
STATS_MOMENT_LIMIT = 1e-12
KERAS_WEIGHTED = 107  # Conv2D 53 + BatchNormalization 53 + Dense 1
# the bn kernels at the Keras ResNet50 path's float32 b32 shapes
KERAS_BN_CASES = [
    ("keras_stem", 401408, 64, "float32", "relu", False),
    ("keras_res2", 100352, 256, "float32", "relu", True),
    ("keras_res5", 1568, 2048, "float32", "relu", True),
]
# keras_cnn: a Keras Sequential CNN with batch norm (imported as a
# MultiLayerNetwork, whose records carry activations)
KERAS_CNN_SIDE, KERAS_CNN_BATCH, KERAS_CNN_STEPS = 32, 16, 3
# mlpipeline: a seeded 4-class set of MLP_ROWS x MLP_FEATURES
MLP_ROWS, MLP_FEATURES, MLP_CLASSES, MLP_EPOCHS, MLP_BATCH, MLP_SEED = 2048, 20, 4, 3, 64, 7


def keras_cnn_config() -> dict:
    """A Keras 3 Sequential config: two conv -> batch norm -> relu blocks,
    max pooling, global average pooling, a softmax Dense."""
    def layer(cls, **cfg):
        return {"module": "keras.layers", "class_name": cls, "config": cfg}

    side = KERAS_CNN_SIDE
    layers = [layer("InputLayer", name="input_layer", batch_shape=[None, side, side, 3]),
              layer("Conv2D", name="conv_a", filters=32, kernel_size=[3, 3], strides=[1, 1],
                    padding="same", activation="linear", use_bias=True),
              layer("BatchNormalization", name="bn_a", axis=-1, momentum=0.99, epsilon=1e-3),
              layer("Activation", name="relu_a", activation="relu"),
              layer("MaxPooling2D", name="pool", pool_size=[2, 2], strides=[2, 2],
                    padding="valid"),
              layer("Conv2D", name="conv_b", filters=64, kernel_size=[3, 3], strides=[1, 1],
                    padding="same", activation="linear", use_bias=False),
              layer("BatchNormalization", name="bn_b", axis=-1, momentum=0.99, epsilon=1e-3),
              layer("Activation", name="relu_b", activation="relu"),
              layer("GlobalAveragePooling2D", name="gap"),
              layer("Dense", name="predictions", units=10, activation="softmax",
                    use_bias=True)]
    return {"module": "keras", "class_name": "Sequential",
            "config": {"name": "keras_cnn", "layers": layers}}


def keras_weights(config: dict, seed: int) -> dict:
    """{layer name: [arrays]} in Keras's order and shapes, drawn from
    numpy.random.default_rng(seed): Conv2D kernel (HWIO, He-scaled) and
    bias; BatchNormalization gamma, beta, moving mean and moving variance
    (> 0); Dense kernel and bias. Channels are followed through the config
    (inbound layers for a functional model, the previous layer for a
    Sequential one)."""
    from deeplearning4j_tpu_torch.modelimport.keras import _inbound_names

    rng = np.random.default_rng(seed)
    layers = config["config"]["layers"]
    sequential = config["class_name"] == "Sequential"
    channels, weights, prev = {}, {}, None
    for ld in layers:
        cfg = ld["config"]
        name = ld.get("name") or cfg["name"]
        inbound = [prev] if sequential else _inbound_names(ld)
        c_in = channels.get(inbound[0]) if inbound and inbound[0] else None
        cls = ld["class_name"]
        if cls == "InputLayer":
            c_out = (cfg.get("batch_shape") or cfg["batch_input_shape"])[-1]
        elif cls == "Conv2D":
            kh, kw = cfg["kernel_size"]
            c_out = int(cfg["filters"])
            ws = [rng.standard_normal((kh, kw, c_in, c_out)) * np.sqrt(2.0 / (kh * kw * c_in))]
            if cfg.get("use_bias", True):
                ws.append(0.01 * rng.standard_normal(c_out))
            weights[name] = ws
        elif cls == "BatchNormalization":
            c_out = c_in
            weights[name] = [rng.uniform(0.4, 0.8, c_in), 0.05 * rng.standard_normal(c_in),
                             0.05 * rng.standard_normal(c_in), rng.uniform(1.0, 2.0, c_in)]
        elif cls == "Dense":
            c_out = int(cfg["units"])
            weights[name] = [rng.standard_normal((c_in, c_out)) / np.sqrt(c_in),
                             0.01 * rng.standard_normal(c_out)]
        else:
            c_out = c_in
        channels[name] = c_out
        prev = name
    return {k: [w.astype(np.float32) for w in ws] for k, ws in weights.items()}


class InMemoryKerasArchive:
    """A legacy Keras HDF5 file's contents held in memory, with the read
    surface of ``modelimport.hdf5.Hdf5Archive``: the ``model_config``,
    ``keras_version`` and ``backend`` root attributes, and a
    ``model_weights`` group with ``layer_names`` and, a layer, its
    ``weight_names`` and datasets ``<layer>/<variable>``. Where h5py is
    missing, the importer takes this object where it takes a path."""

    VARS = {"Conv2D": ("kernel", "bias"), "Dense": ("kernel", "bias"),
            "BatchNormalization": ("gamma", "beta", "moving_mean", "moving_variance")}

    def __init__(self, config: dict, weights: dict):
        self._config = config
        self._attrs = {(): {"model_config": json.dumps(config), "keras_version": "3.13.1",
                            "backend": "tensorflow"}}
        self._data = {}
        names = []
        for ld in config["config"]["layers"]:
            name = ld.get("name") or ld["config"]["name"]
            names.append(name)
            ws = weights.get(name, [])
            wnames = [f"{name}/{v}" for v in self.VARS.get(ld["class_name"], ())[:len(ws)]]
            self._attrs[("model_weights", name)] = {"weight_names": wnames}
            self._data[name] = dict(zip(wnames, ws))
        self._attrs[("model_weights",)] = {"layer_names": names}

    def close(self):
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def has_attribute(self, name, *groups) -> bool:
        return name in self._attrs.get(tuple(groups), {})

    def read_attribute_as_string(self, name, *groups) -> str:
        return self._attrs[tuple(groups)][name]

    def read_attribute_as_json(self, name, *groups) -> dict:
        return json.loads(self.read_attribute_as_string(name, *groups))

    def read_attribute_as_string_list(self, name, *groups) -> list:
        return list(self._attrs[tuple(groups)][name])

    def read_dataset(self, name, *groups) -> np.ndarray:
        return self._data[groups[-1]][name]

    def get_groups(self, *groups) -> list:
        return list(self._data) if tuple(groups) == ("model_weights",) else []

    def has_group(self, name, *groups) -> bool:
        return name == "model_weights" and not groups

    def walk_datasets(self, *groups):
        return list(self._data[groups[-1]].items())


def write_keras_h5(path, config: dict, weights: dict):
    """The same contents as a legacy Keras HDF5 file (for a host with h5py)."""
    import h5py

    arch = InMemoryKerasArchive(config, weights)
    with h5py.File(path, "w") as f:
        for k, v in arch._attrs[()].items():
            f.attrs[k] = v
        g = f.create_group("model_weights")
        g.attrs["layer_names"] = np.array([n.encode() for n in arch._data], dtype="S")
        for name, ds in arch._data.items():
            lg = g.create_group(name)
            lg.attrs["weight_names"] = np.array([w.encode() for w in ds], dtype="S")
            for wname, arr in ds.items():
                lg.create_dataset(wname, data=arr)


def open_keras(config: dict, weights: dict, workdir: str):
    """(source for import_keras_*, how it was opened): a legacy .h5 file
    where h5py imports, else the in-memory archive."""
    import importlib.util

    if importlib.util.find_spec("h5py") is None:
        print("keras_archive: in-memory (no h5py on this host)", flush=True)
        return InMemoryKerasArchive(config, weights), "in-memory"
    path = os.path.join(workdir, config["config"].get("name", "model") + ".h5")
    write_keras_h5(path, config, weights)
    print(f"keras_archive: legacy .h5 through h5py ({path})", flush=True)
    return path, "h5"


def np_stats(a: np.ndarray, bins: int) -> dict:
    """The JAX listener's _stats_of and _histogram of one array (numpy)."""
    a = np.asarray(a, np.float64).ravel()
    a = a[np.isfinite(a)]
    if a.size == 0:
        return {"mean": 0.0, "stdev": 0.0, "mean_magnitude": 0.0,
                "histogram": {"min": 0.0, "max": 0.0, "counts": [0] * bins}}
    lo, hi = float(a.min()), float(a.max())
    if lo == hi:
        hi = lo + 1e-12
    counts, _ = np.histogram(a, bins=bins, range=(lo, hi))
    return {"mean": float(a.mean()), "stdev": float(a.std(ddof=1)) if a.size > 1 else 0.0,
            "mean_magnitude": float(np.abs(a).mean()),
            "histogram": {"min": lo, "max": hi, "counts": counts.tolist()}}


def hold_stats_group(what: str, got: dict, leaves: dict, bins: int) -> float:
    """Every leaf's listener entry against numpy's on the host copy: counts,
    min and max exact, moments within STATS_MOMENT_LIMIT of the leaf's
    largest finite magnitude. Returns the largest moment error over that
    magnitude."""
    if set(got) != set(leaves):
        raise AssertionError(f"{what}: leaves {sorted(got)[:4]}... != {sorted(leaves)[:4]}...")
    worst = 0.0
    for name, arr in leaves.items():
        want, have = np_stats(arr, bins), got[name]
        if have["histogram"] != want["histogram"]:
            raise AssertionError(f"{what} {name}: histogram {have['histogram']} != numpy "
                                 f"{want['histogram']}")
        fin = np.abs(arr[np.isfinite(arr)])
        mag = float(fin.max()) if fin.size else 0.0
        for k in ("mean", "stdev", "mean_magnitude"):
            err = abs(have[k] - want[k])
            if err > STATS_MOMENT_LIMIT * mag:
                raise AssertionError(f"{what} {name}: {k} {have[k]} against numpy {want[k]} "
                                     f"(limit {STATS_MOMENT_LIMIT} x {mag})")
            worst = max(worst, err / mag if mag else err)
    return worst


class _HostLeaves:
    """A listener that keeps a host copy of every parameter leaf at each
    iteration (for the numpy check of the StatsListener's records)."""

    def __init__(self):
        self.copies = []

    def iteration_done(self, model, iteration, epoch):
        from deeplearning4j_tpu_torch.ui.stats import _flatten_params
        self.copies.append({k: v.detach().to("cpu", copy=True).numpy()
                            for k, v in _flatten_params(model.params).items()})

    def on_epoch_start(self, model):
        pass

    def on_epoch_end(self, model):
        pass


class _Tee:
    """One StatsListener writing to a storage and a remote router."""

    def __init__(self, *routes):
        self.routes = routes

    def put_static_info(self, record):
        for r in self.routes:
            r.put_static_info(record)

    def put_update(self, record):
        for r in self.routes:
            r.put_update(record)


def hold_reports(storage, session, host, bins, what) -> dict:
    """Each update record of ``session`` against numpy on ``host`` (the
    host copies at each report): parameters, and updates from the second
    report on (the float32 difference of consecutive copies)."""
    from deeplearning4j_tpu_torch.ui.stats import TYPE_ID

    recs = storage.get_all_updates(session, TYPE_ID)
    if len(recs) != len(host):
        raise AssertionError(f"{what}: {len(recs)} reports for {len(host)} steps")
    worst = 0.0
    for i, rec in enumerate(recs):
        worst = max(worst, hold_stats_group(f"{what} report {i} parameters",
                                            rec["parameters"], host[i], bins))
        if i:
            diff = {k: host[i][k] - host[i - 1][k] for k in host[i]}
            worst = max(worst, hold_stats_group(f"{what} report {i} updates",
                                                rec["updates"], diff, bins))
        elif "updates" in rec:
            raise AssertionError(f"{what}: the first report carries updates")
    return {"reports": len(recs), "max_moment_err_of_magnitude": worst,
            "collection_ms": [r["stats_collection_duration_ms"] for r in recs]}


def hold_ui_routes(base, session, file_storage, reports) -> dict:
    """The UI server's routes over what the router posted: /api/sessions,
    /api/static, /api/updates (every report), /train, /metrics."""
    from deeplearning4j_tpu_torch.ui.stats import TYPE_ID

    out = {}
    code, sessions, _, _ = _http(base, "GET", "/api/sessions")
    out["/api/sessions"] = code
    if code != 200 or session not in sessions:
        raise AssertionError(f"ui: /api/sessions {code} {sessions}")
    code, static, _, _ = _http(base, "GET", f"/api/static?session={session}")
    out["/api/static"] = code
    want = json.loads(json.dumps(file_storage.get_static_info(session, TYPE_ID)))
    if code != 200 or static != want:
        raise AssertionError(f"ui: /api/static {code} differs from the stats file's record")
    code, updates, _, _ = _http(base, "GET", f"/api/updates?session={session}")
    out["/api/updates"] = code
    want = json.loads(json.dumps(file_storage.get_all_updates(session, TYPE_ID)))
    if code != 200 or len(updates) != reports or updates != want:
        raise AssertionError(f"ui: /api/updates {code}: {len(updates)} records "
                             f"for {reports} reports")
    for path, mark in (("/train", "<html"), ("/metrics", "train_score")):
        code, body, _, _ = _http(base, "GET", path)
        out[path] = code
        if code != 200 or mark not in str(body):
            raise AssertionError(f"ui: {path} {code} without {mark!r}")
    return out


def keras_bn_kernel_phase(torch, dev, flush):
    rows = [bn_case(torch, dev, flush, *case) for case in KERAS_BN_CASES]
    torch.cuda.empty_cache()
    return rows


def _keras_data(torch, dev, n, side, classes, seed):
    """Numpy images and one-hot labels (the same on the card and the CPU)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, side, side, 3)).astype(np.float32)
    y = np.eye(classes, dtype=np.float32)[rng.integers(0, classes, n)]
    return x, y


def keras_resnet50_phase(torch, dev, card, workdir) -> dict:
    """Keras's ResNet50 (224^2, 25.6 M parameters) imported, fused and
    fine-tuned on the card under the StatsListener, served to a UIServer:

    - import: ``import_keras_model_and_weights`` of the committed config and
      seeded weights (through an in-memory archive, or a .h5 file where h5py
      imports) on the card and on the CPU; 107 weighted layers; on a .h5
      also ``model_guesser.load_model_guess``; ``fuse_network`` gives 53
      FusedConvBNActivation blocks; Adam 1e-4 for the fine-tuning;
    - card against CPU: the fused network's eval-mode output at b = 4
      within KERAS_OUT_LIMIT of the CPU's largest magnitude, the first
      step's loss within KERAS_LOSS_RTOL of the CPU's ``score_dataset``
      (the plain bn versions, train-mode statistics);
    - KERAS_STEPS ``fit`` steps at b = 32 float32 with a StatsListener at
      frequency 1 writing to a FileStatsStorage and, through a
      RemoteUIStatsStorageRouter, to a UIServer on 127.0.0.1: each step
      launches bn_act_fwd 53 and bn_act_bwd 53 times; every report's
      parameter and update statistics against numpy on host copies of the
      same leaves; the device-memory fields present; every UI route answers
      and /api/updates holds every report;
    - KERAS_TIMED_STEPS steps timed with and without the listener, and one
      parameter group's reduction alone (host ms, device kernels and ms).

    Returns the bn launches of the phase."""
    import dataclasses

    from deeplearning4j_tpu_torch.datasets import DataSet
    from deeplearning4j_tpu_torch.modelimport import import_keras_model_and_weights
    from deeplearning4j_tpu_torch.nn.conf.convolutional import FusedConvBNActivation
    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
    from deeplearning4j_tpu_torch.optimize.updaters import Adam
    from deeplearning4j_tpu_torch.perf.fusion import fuse_network
    from deeplearning4j_tpu_torch.perf.kernels import bn_act
    from deeplearning4j_tpu_torch.storage import FileStatsStorage, InMemoryStatsStorage
    from deeplearning4j_tpu_torch.storage.remote import RemoteUIStatsStorageRouter
    from deeplearning4j_tpu_torch.ui import StatsListener, UIServer
    from deeplearning4j_tpu_torch.ui.stats import TYPE_ID, _flatten_params, reduce_leaves
    from deeplearning4j_tpu_torch.utils import model_guesser

    t_phase = time.perf_counter()
    bn_act.fwd_launches = bn_act.bwd_launches = 0
    with open(KERAS_RESNET50_JSON, encoding="utf-8") as f:
        config = json.load(f)
    weights = keras_weights(config, KERAS_SEED)
    source, how = open_keras(config, weights, workdir)
    t0 = time.perf_counter()
    imported = import_keras_model_and_weights(source, device=dev)
    import_s = time.perf_counter() - t0
    cpu_imported = import_keras_model_and_weights(source, device="cpu")
    if how == "h5":
        guessed = model_guesser.load_model_guess(source, device=dev)
        if not _same_bits(torch, guessed.params, imported.params):
            raise AssertionError("keras_resnet50: load_model_guess differs from the import")
        del guessed
    weighted = sum(1 for p in imported.params.values() if p)
    n_params = imported.num_params()
    if weighted != KERAS_WEIGHTED:
        raise AssertionError(f"keras_resnet50: {weighted} weighted layers, want {KERAS_WEIGHTED}")

    def fine_tune(net):
        fused = fuse_network(net)
        conf = dataclasses.replace(fused.conf, updater=Adam(learning_rate=1e-4))
        return ComputationGraph(conf, fused.device).set_params(fused.params, fused.state)

    net, cpu_net = fine_tune(imported), fine_tune(cpu_imported)
    del imported, cpu_imported
    blocks = sum(1 for layer, _ in net.conf.vertices.values()
                 if isinstance(layer, FusedConvBNActivation))
    if blocks != RESNET50_FUSED_BLOCKS:
        raise AssertionError(f"keras_resnet50: {blocks} fused blocks")

    # card against CPU: eval output at b = 4, the first step's loss
    x4, _ = _keras_data(torch, dev, KERAS_EVAL_BATCH, KERAS_SIDE, KERAS_CLASSES, 1)
    out, cpu_out = net.output_single(x4), cpu_net.output_single(x4)
    out_err = float(np.abs(out.astype(np.float64) - cpu_out).max())
    out_mag = float(np.abs(cpu_out).max())
    if (out.shape != (KERAS_EVAL_BATCH, KERAS_CLASSES) or not np.isfinite(out).all()
            or out_err > KERAS_OUT_LIMIT * out_mag):
        raise AssertionError(f"keras_resnet50: eval output {out.shape} off the CPU's by "
                             f"{out_err} (limit {KERAS_OUT_LIMIT} x {out_mag})")
    x, y = _keras_data(torch, dev, KERAS_BATCH, KERAS_SIDE, KERAS_CLASSES, 2)
    cpu_loss = cpu_net.score_dataset(DataSet(x, y))
    del cpu_net
    ds = DataSet(torch.from_numpy(x).to(dev), torch.from_numpy(y).to(dev))

    # fit under the listener, the records to a file and over HTTP to a UI server
    session = "keras_resnet50"
    storage = FileStatsStorage(os.path.join(workdir, "keras_resnet50_stats.jsonl"))
    server = UIServer(0, "127.0.0.1").attach(InMemoryStatsStorage())
    base = f"http://127.0.0.1:{server.port}"
    router = RemoteUIStatsStorageRouter(base, max_retries=3, retry_backoff_s=0.05, seed=0)
    try:
        listener = StatsListener(_Tee(storage, router), frequency=1, session_id=session,
                                 worker_id="card0")
        host = _HostLeaves()
        net.set_listeners(listener, host)
        steps, losses = [], []
        for _ in range(KERAS_STEPS):
            f0, b0 = bn_act.fwd_launches, bn_act.bwd_launches
            t0 = time.perf_counter()
            net.fit(ds)
            torch.cuda.synchronize(dev)
            steps.append({"bn_act_fwd": bn_act.fwd_launches - f0,
                          "bn_act_bwd": bn_act.bwd_launches - b0,
                          "ms": (time.perf_counter() - t0) * 1e3})
            losses.append(net.score())
        want = {"bn_act_fwd": RESNET50_FUSED_BLOCKS, "bn_act_bwd": RESNET50_FUSED_BLOCKS}
        if any({k: s[k] for k in want} != want for s in steps) or not np.isfinite(losses).all():
            raise AssertionError(f"keras_resnet50: steps {steps} (want {want}), losses {losses}")
        loss_err = abs(losses[0] - cpu_loss) / abs(cpu_loss)
        if loss_err > KERAS_LOSS_RTOL:
            raise AssertionError(f"keras_resnet50: first loss {losses[0]} against the CPU's "
                                 f"{cpu_loss} (rtol {KERAS_LOSS_RTOL})")
        held = hold_reports(storage, session, host.copies, listener.histogram_bins,
                            "keras_resnet50")
        recs = storage.get_all_updates(session, TYPE_ID)
        mem = recs[-1]["memory"]
        if not {"device_bytes_in_use", "device_bytes_limit"} <= set(mem):
            raise AssertionError(f"keras_resnet50: no device memory in the record: {mem}")
        static = storage.get_static_info(session, TYPE_ID)
        if static["hardware"]["device_kind"] != torch.cuda.get_device_name(dev):
            raise AssertionError(f"keras_resnet50: static record {static['hardware']}")
        if not router.shutdown():
            raise AssertionError("keras_resnet50: the router did not deliver every record")
        routes = hold_ui_routes(base, session, storage, KERAS_STEPS)
    finally:
        router.shutdown(timeout=1.0)
        server.stop()
        storage.close()

    # step time with and without the listener (its records kept in memory)
    listener.storage = InMemoryStatsStorage()
    timed = {}
    for label, listeners in (("without_listener", ()), ("with_listener", (listener,))):
        net.set_listeners(*listeners)
        ms = []
        for _ in range(KERAS_TIMED_STEPS):
            t0 = time.perf_counter()
            net.fit(ds)
            torch.cuda.synchronize(dev)
            ms.append((time.perf_counter() - t0) * 1e3)
        timed[label] = ms
    # where a report's time goes: one parameter group reduced alone (host
    # ms from an idle card, and its device kernels in a profiler window)
    flat = {k: v.detach() for k, v in _flatten_params(net.params).items()}
    t0 = time.perf_counter()
    reduce_leaves(flat, listener.histogram_bins)
    group_host_ms = (time.perf_counter() - t0) * 1e3
    group = dict(_device_window(torch, lambda: reduce_leaves(flat, listener.histogram_bins)),
                 host_ms=group_host_ms, leaves=len(flat),
                 entries=sum(int(v.numel()) for v in flat.values()))
    del net, ds, flat
    torch.cuda.empty_cache()
    launches = {"fwd": bn_act.fwd_launches, "bwd": bn_act.bwd_launches}
    summary = {
        "card": card, "archive": how, "config_bytes": os.path.getsize(KERAS_RESNET50_JSON),
        "weighted_layers": weighted, "params": n_params, "fused_blocks": blocks,
        "import_s": import_s, "batch": KERAS_BATCH,
        "eval_out_err": out_err, "eval_out_max": out_mag, "eval_limit": KERAS_OUT_LIMIT,
        "first_loss": losses[0], "cpu_loss": cpu_loss, "loss_rel_err": loss_err,
        "losses": losses, "steps": steps, "stats": held, "memory": mem, "ui_routes": routes,
        "step_ms_without_listener": timed["without_listener"],
        "step_ms_with_listener": timed["with_listener"],
        "stats_collection_duration_ms": held["collection_ms"],
        "parameter_group_reduce": group,
        "bn_act_launches": launches, "seconds": time.perf_counter() - t_phase}
    print("keras_resnet50 " + json.dumps(summary), flush=True)
    return launches


def keras_cnn_phase(torch, dev, card, workdir) -> dict:
    """A Keras Sequential CNN with batch norm (keras_cnn_config, seeded
    weights) imported as a MultiLayerNetwork on the card, fused (2 blocks),
    KERAS_CNN_STEPS fit steps under a StatsListener: every report carries
    ``activations``, one entry a layer, each histogram counting every entry
    of that layer's activation of one example, and the device-memory
    fields. Returns the bn launches."""
    from deeplearning4j_tpu_torch.datasets import DataSet
    from deeplearning4j_tpu_torch.modelimport import import_keras_sequential_model_and_weights
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu_torch.perf.fusion import fuse_network
    from deeplearning4j_tpu_torch.perf.kernels import bn_act
    from deeplearning4j_tpu_torch.storage import InMemoryStatsStorage
    from deeplearning4j_tpu_torch.ui import StatsListener
    from deeplearning4j_tpu_torch.ui.stats import TYPE_ID

    t_phase = time.perf_counter()
    bn_act.fwd_launches = bn_act.bwd_launches = 0
    config = keras_cnn_config()
    source, how = open_keras(config, keras_weights(config, KERAS_SEED), workdir)
    net = fuse_network(import_keras_sequential_model_and_weights(source, device=dev))
    if not isinstance(net, MultiLayerNetwork):
        raise AssertionError(f"keras_cnn: imported a {type(net).__name__}")
    storage = InMemoryStatsStorage()
    listener = StatsListener(storage, frequency=1, session_id="keras_cnn", worker_id="card0")
    net.set_listeners(listener)
    x, y = _keras_data(torch, dev, KERAS_CNN_BATCH, KERAS_CNN_SIDE, 10, 3)
    for _ in range(KERAS_CNN_STEPS):
        net.fit(DataSet(x, y))
    torch.cuda.synchronize(dev)
    acts = net.feed_forward(x[:1])
    sizes = [int(a.numel()) for a in acts]
    recs = storage.get_all_updates("keras_cnn", TYPE_ID)
    for rec in recs:
        got = rec.get("activations")
        if got is None or sorted(got, key=int) != [str(i) for i in range(len(acts))]:
            raise AssertionError(f"keras_cnn: report {rec['iteration']} activations "
                                 f"{None if got is None else sorted(got)}")
        for i, n in enumerate(sizes):
            h = got[str(i)]["histogram"]
            if sum(h["counts"]) != n or not h["min"] <= got[str(i)]["mean"] <= h["max"]:
                raise AssertionError(f"keras_cnn: layer {i} activation stats {got[str(i)]}")
        if "device_bytes_in_use" not in rec["memory"]:
            raise AssertionError(f"keras_cnn: no device memory in {rec['memory']}")
    launches = {"fwd": bn_act.fwd_launches, "bwd": bn_act.bwd_launches}
    want = 2 * KERAS_CNN_STEPS
    if len(recs) != KERAS_CNN_STEPS or launches["bwd"] != want or launches["fwd"] < want:
        raise AssertionError(f"keras_cnn: {len(recs)} reports, bn launches {launches}")
    summary = {"card": card, "archive": how, "layers": len(acts), "activation_sizes": sizes,
               "reports": len(recs), "losses": [r["score"] for r in recs],
               "stats_collection_duration_ms": [r["stats_collection_duration_ms"]
                                                for r in recs],
               "bn_act_launches": launches, "seconds": time.perf_counter() - t_phase}
    print("keras_cnn " + json.dumps(summary), flush=True)
    return launches


def _mlp_conf():
    from deeplearning4j_tpu_torch.nn.conf import InputType, NeuralNetConfiguration
    from deeplearning4j_tpu_torch.nn.conf.layers import DenseLayer, OutputLayer
    from deeplearning4j_tpu_torch.optimize.updaters import Adam
    return (NeuralNetConfiguration.builder()
            .seed(MLP_SEED).updater(Adam(0.01)).weight_init("xavier").list()
            .layer(DenseLayer(n_out=128, activation="relu"))
            .layer(DenseLayer(n_out=64, activation="relu"))
            .layer(OutputLayer(n_out=MLP_CLASSES, activation="softmax", loss="mcxent"))
            .set_input_type(InputType.feed_forward(MLP_FEATURES)).build())


def mlpipeline_phase(torch, dev, card) -> dict:
    """DL4JClassifier fits a seeded synthetic set on the card; its
    probabilities and predictions equal, bitwise, a MultiLayerNetwork
    ``fit`` on the same seed over the same batches in the same order;
    accuracy above chance; clone keeps its parameters."""
    from deeplearning4j_tpu_torch.datasets import DataSet
    from deeplearning4j_tpu_torch.mlpipeline import DL4JClassifier
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork

    t_phase = time.perf_counter()
    rng = np.random.default_rng(MLP_SEED)
    X = rng.standard_normal((MLP_ROWS, MLP_FEATURES)).astype(np.float32)
    y = np.argmax(X @ rng.standard_normal((MLP_FEATURES, MLP_CLASSES)), axis=1)
    clf = DL4JClassifier(conf=_mlp_conf, epochs=MLP_EPOCHS, batch_size=MLP_BATCH,
                         seed=MLP_SEED, device=dev)
    t0 = time.perf_counter()
    clf.fit(X, y)
    fit_s = time.perf_counter() - t0
    proba, pred = clf.predict_proba(X), clf.predict(X)

    net = MultiLayerNetwork(_mlp_conf(), dev).init(MLP_SEED)
    onehot = np.eye(MLP_CLASSES, dtype=np.float32)[y]
    order_rng = np.random.default_rng(MLP_SEED)
    for _ in range(MLP_EPOCHS):
        order = order_rng.permutation(MLP_ROWS)
        for s in range(0, MLP_ROWS, MLP_BATCH):
            idx = order[s:s + MLP_BATCH]
            net.fit(DataSet(X[idx], onehot[idx]))
    plain = net.output(X).cpu().numpy()
    acc = clf.score(X, y)
    clone = type(clf)(**clf.get_params())
    if not (np.array_equal(proba, plain) and np.array_equal(pred, plain.argmax(-1))
            and next(iter(clf.model_.params[0].values())).is_cuda
            and acc > 2.0 / MLP_CLASSES and clone.get_params() == clf.get_params()):
        raise AssertionError(f"mlpipeline: estimator against fit: max |diff| "
                             f"{float(np.abs(proba - plain).max())}, accuracy {acc}")
    summary = {"card": card, "rows": MLP_ROWS, "features": MLP_FEATURES,
               "classes": MLP_CLASSES, "epochs": MLP_EPOCHS, "batch": MLP_BATCH,
               "bitwise_fit": True, "accuracy": acc, "fit_s": fit_s,
               "seconds": time.perf_counter() - t_phase}
    print("mlpipeline " + json.dumps(summary), flush=True)
    return summary


PHASE_SECONDS = {}


def _run(phase, *args):
    """Call one phase of main() and note its seconds in PHASE_SECONDS."""
    t0 = time.perf_counter()
    out = phase(*args)
    PHASE_SECONDS[phase.__name__] = time.perf_counter() - t0
    return out


def _build_dir():
    from deeplearning4j_tpu_torch.perf.kernels import _build
    _build.BUILD.mkdir(parents=True, exist_ok=True)
    return _build.BUILD


def _adc_kernel_entry(name, rows, by_path, replaces_line):
    """The kernels-line entry of adc_pq or adc_ivf_pq: numbers at b = 256 on
    the 1M-vector index, max error over every case, the other served
    batches beside, each with its first design's time (previous_ms), and
    the launches of each path."""
    head = next(r for r in rows if r["b"] == max(ADC_BATCHES) and r["case"] != "ragged")
    timed = ("ms", "host_ms") + (("previous_ms",) if "previous_ms" in head else ())
    return {"name": name, "route": "cuda",
            "source": f"deeplearning4j_tpu_torch/csrc/{name}.cu",
            "replaces": f"deeplearning4j_tpu/perf/pallas/adc.py:{replaces_line}",
            "launches": sum(by_path.values()), "launches_by_path": by_path,
            "max_abs_err": max(r["max_abs_err"] for r in rows),
            **{k: head[k] for k in timed}, "plain_ms": head["plain_ms"],
            "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
            "library_ms": head["library_ms"],
            "shape": {k: head[k] for k in ("b", "n", "C", "p", "M", "ksub") if k in head},
            "other_batches": [{k: r[k] for k in ("b",) + timed + ("plain_ms", "bound_ms",
                                                                 "library_ms")}
                              for r in rows if r["case"] != "ragged" and r is not head]}


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
    # the *_v1 sources are the first designs of int4_dot, flash_attn_fwd,
    # scatter_add, flash_attn_bwd_dkv (flash_attn_bwd_v1), flash_attn_bwd_dq,
    # bn_act_bwd, bn_act_fwd, adc_pq, adc_ivf_pq and the bn kernels' split
    # launches (bn_act_split_v1), timed beside their redesigns (previous_ms)
    names = ["int4_dot", "bn_act_fwd", "bn_act_bwd", "adc_pq", "adc_ivf_pq",
             "scatter_add", "flash_attn_fwd", "flash_attn_bwd_dkv", "flash_attn_bwd_dq",
             "int4_dot_v1", "bn_act_fwd_v1", "bn_act_bwd_v1", "adc_pq_v1", "adc_ivf_pq_v1",
             "flash_attn_fwd_v1", "scatter_add_v1", "flash_attn_bwd_v1",
             "flash_attn_bwd_dq_v1", "bn_act_split_v1"]
    t0 = time.perf_counter()
    _build.build(names)
    PHASE_SECONDS["build"] = time.perf_counter() - t0
    print(f"built {', '.join(names)} in {PHASE_SECONDS['build']:.1f} s", flush=True)
    for name in names:
        log = _build.build_log.get(name, "")
        print(f"ptxas {name}: {ptxas_summary(log)}", flush=True)
        print(log.strip(), flush=True)
    hmma = sass_counts(_build, ("flash_attn_fwd", "flash_attn_bwd_dkv", "flash_attn_bwd_dq"),
                       "HMMA.16816.F32.BF16")

    flush = torch.empty(256 << 20, dtype=torch.int8, device=dev)
    rows = _run(kernel_phase, torch, dev, flush)
    bn_rows = (_run(bn_kernel_phase, torch, dev, flush)
               + _run(yolo_bn_kernel_phase, torch, dev, flush)
               + _run(keras_bn_kernel_phase, torch, dev, flush))
    launches, buckets = _run(serving_phase, torch, dev, card)
    bn_fwd, bn_bwd = _run(training_phase, torch, dev, card)
    _run(card_vs_cpu_phase, torch, dev)
    # retrieval's IVF-PQ and ivf's four IVFIndex variants share one cell
    # training (SharedIvfCells), removed after the ivf phase
    cells = SharedIvfCells().install()
    pq_rows, ivf_rows, int4_retr, served, kept = _run(retrieval_phase, torch, dev, flush, card)
    int4_head = next(r for r in int4_retr if r["b"] == max(ADC_BATCHES))
    scatter_rows, w2v = _run(word2vec_phase, torch, dev, flush, card)
    flash_rows = _run(flash_kernel_phase, torch, dev, flush)
    lm = _run(transformer_phase, torch, dev, card)
    bwd_rows = _run(flash_bwd_kernel_phase, torch, dev, flush)
    train = _run(lm_training_phase, torch, dev, card)
    _run(lm_training_card_vs_cpu, torch, dev)
    _run(lenet_phase, torch, dev)
    _run(char_rnn_phase, torch, dev, card)
    _run(char_rnn_card_vs_cpu, torch, dev)
    _run(graph_char_rnn_phase, torch, dev, card)
    workdir = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        ckpt = _run(checkpoint_phase, torch, dev, card, workdir)
        _run(serialization_phase, torch, dev, card, ckpt)
        overhead = _run(checkpoint_overhead_phase, torch, dev, card, workdir)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    workdir = tempfile.mkdtemp(prefix="chip_smoke_cloud_")
    try:
        cloud = _run(cloud_checkpoint_phase, torch, dev, card, workdir, ckpt)
        supervised = _run(supervised_phase, torch, dev, card, workdir, ckpt)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    del ckpt["record"]
    yolo = _run(yolo_training_phase, torch, dev, card)
    _run(yolo_card_vs_cpu_phase, torch, dev)
    facenet = _run(facenet_training_phase, torch, dev, card)
    zoo = _run(zoo_phase, torch, dev)
    families = _run(layer_families_phase, torch, dev)
    ms_launches, vgg_fp32, vgg_rec = _run(model_server_phase, torch, dev, card, kept)
    swap_launches = _run(hot_swap_phase, torch, dev, card, vgg_fp32, vgg_rec)
    workdir = tempfile.mkdtemp(prefix="chip_smoke_fleet_")
    try:
        fleet_launches = _run(fleet_phase, torch, dev, card, vgg_fp32, vgg_rec, workdir)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    del vgg_fp32
    torch.cuda.empty_cache()
    _run(decode_phase, torch, dev, card)
    ivf_rows_served = _run(ivf_phase, torch, dev, card, kept)
    cells.remove()
    print(f"ivf cells trained {cells.trained} time(s), reused {cells.reused}", flush=True)
    ivf_launches = {k: sum(r["launches"][k] for r in ivf_rows_served)
                    for k in ("int4_dot", "adc_pq", "adc_ivf_pq")}
    del kept
    workdir = tempfile.mkdtemp(prefix="chip_smoke_data_")
    try:
        data = _run(data_tier_phase, torch, dev, card, workdir)
        gates = _run(lenet_gates_phase, torch, dev, card, workdir, flush)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    net50, full, fused_launches = _run(fused_update_phase, torch, dev, card)
    workdir = tempfile.mkdtemp(prefix="chip_smoke_tl_")
    try:
        tl_launches, featurized = _run(transfer_learning_phase, torch, dev, card, net50, full,
                                       workdir)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    del net50
    torch.cuda.empty_cache()
    workdir = tempfile.mkdtemp(prefix="chip_smoke_perf_")
    try:
        perf_launches = _run(perf_tier_phase, torch, dev, card, workdir)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    torch.cuda.empty_cache()
    workdir = tempfile.mkdtemp(prefix="chip_smoke_keras_")
    try:
        keras_launches = _run(keras_resnet50_phase, torch, dev, card, workdir)
        keras_cnn_launches = _run(keras_cnn_phase, torch, dev, card, workdir)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    torch.cuda.empty_cache()
    _run(mlpipeline_phase, torch, dev, card)
    _run(solvers_phase, torch, dev, card)
    _run(streaming_phase, torch, dev, card)
    graph_launches = _run(graph_embeddings_phase, torch, dev, card)
    _run(cnn_sentence_phase, torch, dev, card)
    par_launches = _run(parallel_training_phase, torch, dev, card)
    workdir = tempfile.mkdtemp(prefix="chip_smoke_elastic_")
    try:
        elastic = _run(elastic_phase, torch, dev, card, workdir)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    torch.cuda.empty_cache()
    workdir = tempfile.mkdtemp(prefix="chip_smoke_dp2_")
    try:
        dp2 = _run(data_parallel_world2_phase, torch, dev, card, workdir)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    mp, split_rows = _run(model_parallel_phase, torch, dev, card, flush)
    bn_launches = {kind: {"training": n, "checkpoint": ckpt[kind],
                          "checkpoint_overhead": overhead[kind], "yolo_training": yolo[kind],
                          "facenet_training": facenet[kind], "zoo": zoo[kind],
                          "layer_families": families[kind], "data_tier": data[kind],
                          "fused_update": fused_launches[kind],
                          "transfer_learning": tl_launches[kind],
                          "fit_featurized": featurized[kind],
                          "cloud_checkpoint": cloud[kind], "supervised": supervised[kind],
                          **par_launches[kind], "elastic": elastic[kind],
                          "data_parallel_world2": dp2[kind], "model_parallel": mp[kind],
                          "perf_tier": perf_launches[kind],
                          "keras_resnet50": keras_launches[kind],
                          "keras_cnn": keras_cnn_launches[kind]}
                   for kind, n in (("fwd", bn_fwd), ("bwd", bn_bwd))}

    # the kernel line reports fc1 at the batch the serving phase dispatched
    # most often, timed above or here
    t0 = time.perf_counter()
    b = max(buckets, key=buckets.get)
    n, d = FC_SHAPES[0]
    fc1 = next((r for r in rows if (r["b"], r["n"], r["d"]) == (b, n, d)), None)
    fc1 = fc1 or kernel_case(torch, dev, flush, b, n, d)
    PHASE_SECONDS["kernels_line_fc1"] = time.perf_counter() - t0
    print("phase_seconds " + json.dumps(PHASE_SECONDS), flush=True)
    print(f"chip_smoke ran {time.perf_counter() - t_start:.1f} s on {card}", flush=True)
    print(json.dumps({"kernels": [{
        "name": "int4_dot", "route": "cuda",
        "source": "deeplearning4j_tpu_torch/csrc/int4_dot.cu",
        "replaces": "deeplearning4j_tpu/perf/pallas/adc.py:150",
        # its paths: VGG16 serving, the int4 brute-force index, VGG16
        # behind ModelServer before and after a hot swap, and LeNet's int4
        # layers under the quantization gate
        "launches": (launches + served["int4"]["launches"] + ms_launches["int4_dot"]
                     + swap_launches["int4_dot"] + gates["int4_dot"] + fleet_launches),
        "launches_by_path": {"vgg16_serving": launches,
                             "retrieval_int4": served["int4"]["launches"],
                             "model_server": ms_launches["int4_dot"],
                             "hot_swap": swap_launches["int4_dot"],
                             "ivf": ivf_launches["int4_dot"],
                             "lenet_gates": gates["int4_dot"],
                             "fleet": fleet_launches},
        "max_abs_err": max(r["max_abs_err"] for r in rows + [fc1] + int4_retr + gates["rows"]),
        "ms": fc1["ms"], "host_ms": fc1["host_ms"], "previous_ms": fc1["previous_ms"],
        "plain_ms": fc1["plain_ms"],
        "bound_ms": fc1["bound_ms"], "bound_by": fc1["bound_by"],
        "library_ms": fc1["library_ms"],
        "shape": {"b": b, "n": n, "d": d},
        "retrieval_shape": {k: int4_head[k] for k in INT4_KEYS},
        "retrieval_batches": [{k: r[k] for k in INT4_KEYS} for r in int4_retr
                              if r is not int4_head],
        "lenet_shapes": [{k: r[k] for k in INT4_KEYS} for r in gates["rows"]]},
        _bn_kernel_entry("bn_act_fwd", bn_rows, bn_launches["fwd"], split_rows),
        _bn_kernel_entry("bn_act_bwd", bn_rows, bn_launches["bwd"], split_rows),
        _adc_kernel_entry("adc_pq", pq_rows, {
            "retrieval_pq": served["pq"]["launches"], "model_server": ms_launches["adc_pq"],
            "hot_swap": swap_launches["adc_pq"], "ivf": ivf_launches["adc_pq"]}, 59),
        _adc_kernel_entry("adc_ivf_pq", ivf_rows, {
            "retrieval_ivf_pq": served["ivf_pq"]["launches"],
            "model_server": ms_launches["adc_ivf_pq"],
            "hot_swap": swap_launches["adc_ivf_pq"], "ivf": ivf_launches["adc_ivf_pq"]}, 103),
        _scatter_kernel_entry(scatter_rows, w2v, graph_launches),
        _flash_kernel_entry(flash_rows, lm, train),
        dict(_flash_bwd_kernel_entry("flash_attn_bwd_dkv", bwd_rows, train),
             sass_hmma_bf16=hmma["flash_attn_bwd_dkv"]),
        dict(_flash_bwd_kernel_entry("flash_attn_bwd_dq", bwd_rows, train),
             sass_hmma_bf16=hmma["flash_attn_bwd_dq"])]}),
        flush=True)
    print(f"card: {card}", flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
