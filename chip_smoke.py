#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (paddle_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--profile]

Needs one CUDA device and the CUDA toolkit (nvcc); exits non-zero, and
prints no result, without them or when run outside the repository.
Phases (any failure exits non-zero):

  1. print the card's name and power limit (nvidia-smi) and build the
     paged-attention and flash-attention kernels from
     paddle_tpu_torch/csrc with nvcc (one process per source, in
     parallel); for every paged and flash kernel print the registers,
     stack and spill bytes nvcc reported, and for every flash kernel the
     tensor-core instructions (HMMA/HGMMA) in its SASS (cuobjdump); the
     nine bf16 flash kernels (forward, dK/dV, dQ at D 32/64/128) must
     hold tensor-core instructions and spill nothing;
  2. hold the paged kernels against their plain PyTorch version through
     all three wrappers (decode, verify, prefill chunk) at the serving
     shapes (H=8, Dh=64, Bt=16, 16 slots, contexts up to 1024, a
     128-token chunk at start > 0, a 4-row verify window over 32 slots)
     in bf16 and f32, at one odd shape (Dh=32, Bt=8, R=3) and at Dh 128
     and 40 (WIDE), with -1 table tails (bit-identical to a full table)
     and a parked row; bf16 (the
     split-context kernel and its merge) also against the split plain
     version at the partition count the library reports, relaunched
     bit-identical, and on a case where one slot's context lies in one
     partition and another's spans them all; time the kernels, the plain
     version and (bf16) the split plain version at each of the three
     shapes with a cold L2, with the partition count;
  3. serve a fixed-seed trace of 12 requests through ServingEngine at
     full width in bf16 (vocab 32000, dim 512, 8 heads, 8 layers,
     max_len 1024; 16 slots, 16-token blocks, 128-token chunks, an
     8192-token prefix cache): a shared 128-token header, prompts of
     64-512 tokens, 32-128 new tokens, some sampled, one resubmitted
     whole-block prompt (copy-on-write). The paged launch counters are
     zeroed just before and read just after; decode launches must equal
     layers x decode steps and prefill launches layers x prefill chunks;
  4. the same weights in f32: greedy engine output equals the port's
     sequential generate() token for token for 4 requests, one retiring
     on EOS, through a pool small enough to force backpressure;
  5. hold the three flash kernels (forward o and lse, dK/dV, dQ) against
     their plain versions at the training shape (B 8, T 1024, H 8, D 64,
     causal) in bf16 and f32, at the JAX suite's odd shapes (cross
     attention T 128 / S 384 with D 32, causal T 100 and T 768) and at
     the edges of the tensor-core tiles (D 40 and D 128, causal T 129,
     T 200 / S 72, B*H = 1); launch the bf16 forward, dK/dV and dQ twice
     on the training shape and require bit-identical outputs; time each
     kernel at the training shape in bf16 with a cold L2 beside its
     plain version, its bound and scaled_dot_product_attention (forward,
     and its backward for dK/dV and dQ together), with its registers,
     shared memory, spills and tensor-core instruction count;
  6. train the repo's training configuration (bench.py:913-931: the
     model above, bf16, tokens [8, 1025], SGD lr 1e-3,
     attn_impl="flash"): 2 warm-up steps, then 10 timed steps on one
     fixed batch with the flash counters zeroed just before and read
     just after; every loss finite, each counter = layers x steps;
     tokens/s, ms/step and bench.py's FLOP share of 989 TFLOP/s;
  7. f32 parity: 3 SGD steps (lr 1e-2) from the same weights and batch
     through attn_impl="flash" and attn_impl="reference" agree;
  8. the paged kernel's dequant branch: all three wrappers over int8 and
     fp8 pools with q in bf16 and f32, held against the plain version on
     the same codes and scales at the serving_quant shapes (H 8, Dh 64,
     Bt 32, 32 slots, contexts up to 1024, a 128-row chunk at start 256,
     a 4-row verify window), at phase 11's verify shape (Bt 16, 64
     table entries), at Dh 32, Bt 16, R 3 and at Dh 128, with -1 tails
     (bit-identical) and a parked row, bf16 also against the split plain
     version and relaunched as in phase 2; bf16 timings with a cold L2
     beside the plain versions and the unquantized kernel at the same
     shape;
  9. the repo's serving_quant configuration (bench.py:1783-1808: the
     model above in bf16, 32 slots, 32-token blocks, 128-token chunks,
     an 8192-token prefix cache, one KV byte budget of (max_len // Bt)
     unquantized blocks) over bench.py's trace (64 requests arriving
     Poisson at 2 per step, seed 0; a 128-token header, 32-128 suffix
     tokens, 32-96 new tokens, greedy) through kv_quant none / int8 /
     fp8 and weight_quant int8: decode and prefill launches = layers x
     steps in each run, int8 strictly more resident slots than none;
     slots resident, pool blocks, greedy-prefix agreement with the none
     run and tokens/s per variant (agreement reported, not gated);
 10. f32, the trace's first 8 requests: int8 and fp8 engines through the
     kernel emit the greedy tokens of engines through the gathered view;
 11. the serving_fused configuration (bench.py:1553-1562: 32 slots,
     16-token blocks) over the same trace in bf16, through plain decode
     and then with spec_draft_len 4 for kv_quant none / int8 / fp8:
     verify launches = layers x verify steps, decode launches 0 (plain:
     the reverse); accept rate and tokens/s;
 12. f32, the first 8 requests: spec tokens equal plain-decode tokens
     for kv_quant none and int8;
 13. decode windows and async dispatch: bench_serving_megabatch's
     configuration (bench.py:1093-1180: the model above in bf16, 16
     slots, 64 requests arriving Poisson at 1 per step with seed 0,
     prompts of 64-512 tokens, 128 new tokens, even requests greedy and
     odd ones sampled at T 0.8) through decode_window K in {1, 4, 8},
     sync and async: every variant's tokens equal K=1 sync's, decode
     launches = layers x K x windows and prefill launches = layers x
     chunks, and every steady chained async dispatch (no band dirty)
     runs under torch.cuda.set_sync_debug_mode("error"); steps/token,
     band uploads, the host's share outside dispatch-to-sync spans and
     tokens/s per variant; then the first 16 requests over int8 and fp8
     pools, K=8 async tokens equal to K=1 sync's;
 14. LoRA adapters: phase 3's trace with three of every four requests
     on one of 3 adapters (rank 8) through a pool of 2 payload slots
     (adapter_slots=3, as bench.py:2882): zero-adapter requests emit
     the tokens of an engine without a registry, each adapter request
     the tokens it emits served alone, launches = layers x steps;
 15. KV fingerprints and the durable store: phase 3's trace with
     kv_fingerprints=True trips nothing and emits the same tokens; the
     flip@ drill trips exactly once (kind "fingerprint"); in a temp dir,
     engine A spills a header request's blocks, engine B imports them as
     a handoff with zero closed-block tokens re-prefilled and A's
     tokens, and an engine warmed from the store reopened from disk
     gives A's tokens prefilling only the prompt past the header;
 16. Fluid ResNet-50 training through paddle_tpu_torch.fluid, the repo's
     headline configuration (bench.py:211-229, :515-535):
     resnet_imagenet(depth=50), images [128, 3, 224, 224], 1000
     classes, cross_entropy -> mean, Momentum(0.01, 0.9), program.amp
     (bf16 forward, f32 master params); startup on the card, one fixed
     synthetic batch from np.random.RandomState(0) (int64 labels), 2
     warm-up steps, then 10 timed steps ending in a sync, with
     torch.backends.cudnn.benchmark on: every loss finite and the last
     below the first; img/s, ms/step, peak device memory and bench.py's
     FLOP share (img/s x 3 x 4.09e9 / 989e12);
 17. Fluid f32 parity: resnet_cifar10(depth=8), batch 16, 32x32 f32, 3
     Momentum steps from the same startup weights on CUDAPlace(0) (cuDNN
     TF32 off) and on CPUPlace(): losses within rtol 1e-4, parameters
     and batch-norm running statistics within atol 1e-4;
 18. the Fluid flash_attention op: q/k/v data slots [1024, 8, 64], q
     through an fc, flash_attention(causal=True) -> mean, one SGD step in
     bf16 at batch 8 through the Executor, with the flash counters zeroed
     just before and read just after: forward, backward_kv and
     backward_q each launched exactly once; the op's output held against
     flash_attention_plain at phase 5's bf16 tolerance;
 19. read the device time of each of the two CUDA kernels (split and
     merge) of every bf16 paged call timed in phases 2 and 8
     (torch.profiler; run after phase 24, because a profiler window
     slows the host work of every later phase);
 20. the LSTM benchmark (bench.py:800-850, benchmark/paddle/rnn) through
     the Fluid Executor: embedding 30000 x 128, 2 x (fc to 4*512, then
     dynamic_lstm(2048) with peepholes), sequence_last_step, fc(2,
     softmax), cross_entropy -> mean, Adam(2e-3), program.amp; batch 64
     x 100 tokens (uniform offsets, RandomState(0)), 2 warm-up and 10
     timed steps ending in a sync: every loss finite; ms/step, tokens/s,
     peak device memory and bench.py's FLOP count x 3 over 989 TFLOP/s.
     Then the sync check: the lstm kernel alone, forward and backward,
     at these shapes in bf16 on device tensors with host-known offsets
     under torch.cuda.set_sync_debug_mode("error"): no read back to the
     host;
 21. ragged f32 parity, card vs CPU: the book's stacked_lstm_net (3
     layers, alternating is_reverse) and convolution_net
     (tests/test_understand_sentiment.py: vocab 120, batch 16, widths
     32, lengths 3-20 with a 1 and a maximum that is no power of two)
     and crnn_ctc (paddle_tpu/models/ocr_crnn.py, hidden 48, images
     [8, 1, 32, 128], labels of 1-12 ids), 3 Momentum steps (lr 0.05,
     0.002 for the CRNN; momentum 0.9) from one set of startup weights:
     losses within rtol 1e-4, parameters within atol 1e-4;
 22. the CRNN at its own width (hidden 48, 36 classes), images
     [32, 1, 32, 128] with ragged labels of 4-12 ids, 6 f32 SGD(0.002)
     steps on one fixed batch: losses finite and falling; then the
     greedy decode (ctc_align) of the trained weights through the
     for_test clone;
 23. control flow in f32, card vs CPU in one process: the book's NMT
     (tests/test_machine_translation.py's topology at its widths: dict
     40, word 16, hidden 32, batch 8) trains 3 Adagrad steps from one
     set of startup weights (at lr 0.01 losses within rtol 1e-4 and
     parameters within atol 1e-4; at the book's lr 0.2 the losses) and
     beam-decodes; a beam loop whose beams all end early (the exit
     armed); IfElse, Switch, StaticRNN and a row of ties through top_k:
     ids, lengths, the fetched loop counter and top_k indices equal,
     values within 1e-5;
 24. the book's NMT at full width (the PaddlePaddle book's wmt14
     chapter: dictionaries of 30000, word vectors 512, encoder and
     decoder width 512, fc and dynamic_lstm at 2048, beam 3, topk 10;
     f32): batch 64 pairs of the synthetic reverse-copy
     corpus with 10-50 source tokens (RandomState(0)), Adagrad at lr
     1e-3 (the JAX test's 0.2 saturates the softmax at this width); 2
     warm-up and 10
     timed steps ending in a sync (losses finite and falling; ms/step,
     target tokens/s, peak device memory), then one step under
     torch.cuda.set_sync_debug_mode("error"); a beam decode of the 64
     sources capped at 64 trips (ms per decode, sentences/s, trips,
     mean output length), and one with its synchronizing calls counted:
     at most one per trip after the peel;
 25. bench.py:855-909's sparse-embedding benchmark, uncut (a [1M, 64]
     f32 table, batch 4096 x 8 id fields, reduce_sum -> fc(1) ->
     sigmoid cross-entropy) through the Fluid executor with SGD(0.05)
     and Adam(1e-3), each with is_sparse True and False: 2 warm-up and
     10 timed steps on one batch ending in a sync (ms/step, examples/s,
     touched rows/s, sparse over dense, the peak device memory the timed
     steps add above the resident state); gates: a sparse step adds less
     than one table, one steady sparse SGD and Adam step each run under
     torch.cuda.set_sync_debug_mode("error"), and one more lazy-Adam
     step on a new batch leaves the untouched rows of the table and both
     moments bit-identical (and moves the touched ones);
 26. sparse and sampled f32 parity, card vs CPU from one set of startup
     weights: tests/test_selected_rows.py's model (vocab 50, dim 6,
     duplicate ids, padding_idx) 5 steps each with SGD, Momentum,
     Adagrad and Adam (tables and optimizer state within 1e-6);
     tests/test_ctc_sampled_ops.py's nce and hsigmoid programs 5 Adam
     steps each (losses within rtol 1e-5, nce's sampled labels
     identical); the book's word2vec with is_sparse=True at the book's
     widths (embeddings 32, hidden 256, N 5, batch 32) over a synthetic
     2000-word dictionary, 3 SGD steps (losses within rtol 1e-5);
 27. Wide&Deep and DeepFM (paddle_tpu_torch/models/ctr.py) at full
     width: Criteo's layout (26 id fields in disjoint 40000-id ranges,
     1,040,000 ids, 13 dense features), the DeepFM paper's Criteo
     setting (embeddings 10, deep layers 400-400-400, Adam(1e-3)), batch
     2048, f32, seeded synthetic ids and labels (field 0's id parity
     xor an interaction of fields 1 and 2, 10% noise): 2 warm-up and 10
     timed steps (ms/step, examples/s, peak device memory), then to 30
     steps: the loss must fall; AUC of the last training step and of a
     held-out batch through the for_test clone;
 28. every op the zoo, SRL and SSD slice ports on the card against the
     same kernel on the CPU (seeded inputs): lrn in f32 and bf16, the
     four CRF ops (59 labels, ragged sentences of 1-60 tokens, ties),
     the eight detection ops (NMS over 21 classes x 2000 boxes), with
     the gradients of lrn, linear_chain_crf, roi_pool and
     ssd_multibox_loss; the five learning-rate schedules over 5 SGD
     steps on a force_cpu global step; Accuracy, ChunkEvaluator and
     DetectionMAP (f32 within 1e-5, integers equal, bf16 within 2e-2);
 29. the BASELINE.json image configs, MNIST LeNet (batch 64) and
     VGG-16-bn-drop CIFAR-10 (batch 128), f32 with the books'
     Adam(1e-3) on seeded zero-mean batches: 2 warm-up and 10 timed
     steps (ms/step, img/s, peak memory), the loss falling over 30
     steps, the Accuracy evaluator; 3 f32 Momentum steps at batch 8
     (LeNet) and 32 (VGG), card vs CPU, parameters within 1e-4;
 30. bench.py's ImageNet zoo cells (AlexNet 128, GoogLeNet 128, VGG-16
     64, MobileNet-v1 128 at [3, 224, 224], 1000 classes, bf16 AMP,
     Momentum(0.01, 0.9)): 2 warm-up and 5 timed steps (ms/step, img/s,
     bench.py's FLOP share of 989 TFLOP/s) beside the reference's own
     K40m img/s where bench.py names one; GoogLeNet's lrn ops per step;
 31. the book's SRL at its published widths (word 32, mark 5, hidden
     512, depth 8; conll05's 44,068 words, 3,162 predicates, 59 labels),
     batch 10 synthetic sentences of 10-60 tokens, SGD at
     exponential_decay (base 5e-4: the book's 0.01 diverges on them) on
     a force_cpu global step: ms/step, tokens/s,
     the loss over 30 steps, crf_decoding, ChunkEvaluator P/R/F1; a step
     under torch.cuda.set_sync_debug_mode("error");
 32. ssd_detector at [32, 3, 300, 300] with 21 classes (20,982 priors),
     f32 Adam(2e-3) on seeded single-object images: ms/step, the loss
     falling over 30 steps, a step under set_sync_debug_mode("error"),
     peak memory; the detection_output eval step (ms), its -1-padded
     rows and the host DetectionMAP;
 33-37. the last 14 ops card vs CPU; ResNet-50 under memory_optimize;
     run_grad_accum; ModelAverage and StaticPruning; the executor's
     surface (the verifier, the numerics guard, AsyncDeviceFeeder, the
     profiler) - see each phase function;
 38. the mesh executor on a world of one NCCL rank
     (Executor(mesh=make_mesh({'data': 1}))): phase 16's ResNet-50 loop
     (ms/step, the gradient sync's bytes, buckets and device time a
     step from CUDA events, peak memory) beside phase 16's numbers, its
     losses held against phase 16's; the plain and the mesh executor in
     turns (plain, mesh, mesh, plain; 5 steps a turn); the two executors
     from one startup with cuDNN deterministic, 2 steps: losses and
     every persistable bit-equal; phase 18's flash program on the mesh,
     counters zeroed just before and read just after: one launch each;
 39. two ranks of this script (--mesh-worker RANK DIR) on cuda:0 in a
     gloo group (NCCL refuses two ranks on one card; gloo is named, not
     a fallback) against this process's one-device runs: ResNet-50 f32
     {data: 2} 2 steps of the global batch 128 (first loss within 1e-4:
     batch norm over the global batch; the rest within 1e-4 or twice the
     noise floor of the one-device steps on the batch with its halves
     swapped), LeNet with its fc split over 'model' and with FSDP
     (1e-5), DeepFM at phase 27's width with both tables split along
     their rows (2e-5 absolute), run_async_local at sync_every 1 and 4
     (1e-5); a failing rank fails the phase;
 40. the legacy `paddle train` stack (paddle_tpu_torch.trainer, the
     configs of benchmarks/paddle as they stand): run_config(job="time")
     on resnet.py (ResNet-50, 224, batch 64), alexnet.py, googlenet.py
     and smallnet_mnist_cifar.py (batch 128), vgg.py (VGG-19, batch 64)
     and rnn/rnn.py (batch 128, hidden 128, 100 tokens), f32, with
     cudnn.benchmark on; num_samples is cut to 15 batches a config (the
     trainer reports how many it timed after its warm-up: 10); each
     config's ms/batch and samples/s from the trainer's own "Time:"
     line; ResNet-50's time job beside its own program on one fixed
     batch on the card (no provider, no feeder), timed twice: with the
     cost read back every step, as the trainer reads it, and queued
     with one sync at the end, as phase 16 times its program; and
     phase 16's Fluid ResNet-50 program at the same batch 64 and f32;
     smallnet card vs CPU for 3 batches from one saved init (costs and
     every saved value within 1e-4, cuDNN deterministic); a save_dir ->
     init_model_path resume on the card whose pass equals the
     uninterrupted run's second pass (costs within 1e-6);
 41. the elastic data plane (paddle_tpu_torch.native, .data and
     .distributed's coordinator, supervisor and sentinel): (a) 768
     records in bench.py's layout ([label u16][uint8 3x224x224],
     bench.py:580) written with the native RecordWriter into two files,
     converted to RecordShards (64-record chunks) by from_recordio, and
     read by ShardedDataset -> DataLoader(num_workers=2,
     prefetch_batches=4, device_put=True) into ResNet-50 b64 f32 with
     bench.py's uint8 input (cast and scaled by 1/255 on the card,
     bench.py:214-220): 2 warm-up and 10 timed steps queued with one
     sync, beside the same program on one fixed batch on the card and
     phase 40's phase-16 program at b64 f32; ms/step, img/s and the
     loader's wait_fraction; the delivered labels, each batch's pixel
     sum and the first batch's pixels equal the synchronous
     (num_workers=0) pass's; (b) smallnet_mnist_cifar.py through
     run_config(recordio=[a glob of two record files of pickled
     instances]) for 3 batches of 128 on the card and on the CPU from
     one saved init, costs within 1e-4 (cuDNN deterministic); (c) a
     CoordinatorServer and a Supervisor over two worker processes of
     this script (--data-worker OUT CKPT ADDR SHARDS), each training
     LeNet on the card from chunks leased through
     CoordinatedChunkSource (1,024 MNIST-shaped records in 16 chunks,
     batch 32) with the training sentinel and a checkpoint a step; w0
     runs with PADDLE_FAULT=kill@5, w1 with nanloss@7: the delivered
     record multiset equals the dataset, the queue drains, w0 restarts
     for `crash` from its checkpoint and w1 for `sentinel_rollback`
     from its known-good step;
 42. the serving fleet (paddle_tpu_torch.serving.fleet, .frontdoor,
     .tenancy, .loadgen; analysis.protocol_lint audits every journal
     with expect_closed): phase 3's model at HALF_DEPTH (4 of its 8
     layers) in bf16 with the ENGINE
     settings per replica over the POISSON trace (seed 0), every
     replica thread launching the paged kernels on the one card. (a)
     ServingFleet(n_replicas=1), n_replicas=3 with prefix affinity,
     n_replicas=3 with kill_replica of the replica holding the most
     work once a third of the trace is submitted (failovers == 1), a
     tiered fleet (one prefill and two decode replicas, kv_store_dir,
     KV fingerprints: handoff imports > 0 and no closed-block token
     recomputed at migration, bench.py:3328-3335's bar) and 3-replica
     fleets with int8 and fp8 pools over the trace's first 8 requests
     (budgets capped at 32 tokens):
     every request done with its budget's tokens in the vocabulary,
     lost 0, one terminal record per rid, the journal clean; the paged
     counters zeroed just before and read just after each run: decode
     launches = layers x the engines' decode steps and prefill launches
     = layers x their prefill chunks (at least that in the kill run);
     tokens/s at N=1 and N=3; (a') the same drill in f32 over the first
     16 requests, every third sampled: the fleet's tokens equal one f32
     engine's for every request; (b) save_weights of a second weight
     set (the first plus 0.01 N(0, 1), seed 1) and roll_weights to it
     once a third of 32 requests of the trace (seed 2) is submitted (the
     rest wait for it), policy
     "finish", canaries every 0.5 s (each version's known answer from
     one engine of the fleet's configuration, generate()'s logged
     beside it): every done's weights_version equals its last
     assignment's, every rolled replica holds the second set bit for
     bit in bf16 on the card, no integrity trip; (c) a FrontDoor over
     a two-replica fleet with two tenants (auth tokens, WFQ weights
     2:1, bench.py:3413-3620's serving_frontdoor): the wire answer
     equals the direct one, a capacity estimate from one wave of 16
     requests, run_open_loop at 0.25x and 1x that rate for 5 s each,
     every request streamed (chunks concatenate to the done frame, no
     request without a typed verdict; goodput and TTFT p50 / p99
     logged), then a streamed request whose client disconnects
     (journaled `cancelled`); (d) 4 batches of the book's LeNet
     inference at batch 64 through submit_batch(executor_batch_fn)
     between 8 f32 LM requests: every fetch within 1e-5 of a direct
     Executor.run; the flash counters read before (a) and after (d)
     must not have moved (flash is not on the serving path);
 43. the LM's remaining paths at phase 3's width (8 layers), bf16 unless
     stated, with two ranks of this script (--lm-worker RANK DIR) on
     cuda:0 in a gloo group for (a)-(d): (a) {seq: 2}, B 2 x T 4096,
     causal: forward with ring, zigzag and flash (Ulysses over the flash
     kernels) within 2e-2 x the largest |logit| of this rank's
     one-device flash forward (the absolute 2e-2 logged: under one bf16
     step at |logit| 4-8), then 3 SGD steps through Ulysses + flash
     with the flash counters zeroed just before and read just after
     (forward, dK/dV and dQ launches = layers x steps in each rank), the
     losses finite and equal across ranks; (b) the Switch LM (8 experts
     every 2 blocks) over {expert: 2}, 8 x 1024 tokens: in f32 at
     capacity factor 8 (nothing dropped) the loss within 1e-5 of the
     one-device reference_moe loss, in bf16 at 1.25 3 steps finite with
     each rank's dropped tokens read from its mesh's SyncStats; (c)
     {model: 2}, f32, parameters laid out by param_specs: the loss
     within 1e-5 of the one-device loss;
     (d) {pipe: 2}, 8 microbatches of two GELU MLP stages 512 -> 2048 ->
     512 at B 256, f32: forward and gradients within 1e-5 of
     reference_pipeline; (e) in this process, the Switch LM: 10 SGD
     steps through flash with the loss falling, f32 greedy generate
     equal to the CPU port's, beam search (beam 1 = greedy, scores
     sorted, LAST_DECODE_STATS), prefill_chunk in chunks of 128 over a
     512-token prompt against prefill in f32 (within 1e-5; whether bit
     for bit is logged: cuBLAS picks its f32 GEMM kernels by row count),
     and the fused paged prefill and decode over 16 slots with MoE
     blocks (launches = layers x chunks and layers x steps, the
     launches over quantized pools counted apart; logits within 2e-2 of
     the largest |logit| of the gather path's);
 44. the v2 book and the deploy path, with the datasets' cache in a
     temporary directory and g++ building the native inference runner
     (paddle_tpu_torch/native/inference.cc) beside the training: (a)
     recognize_digits through the v2 API at LeNet's widths (conv 20@5x5,
     pool 2; conv 50@5x5, pool 2; fc 10 softmax), mnist.fetch() writing
     the IDX files the readers then decode, paddle.batch(paddle.reader
     .shuffle(mnist.train(), 8192), 64), 2 passes of the book's
     Momentum(0.1 / 128, 0.9) on the card: every cost finite, the last
     pass's mean cost below the first's, trainer.test; paddle.infer on
     the 128 test images on the card, then to_tar, merge_v2_model and
     InferenceRunner on the host: probabilities within 1e-4 of the
     card's, argmax equal on all 128; (b) understand_sentiment through
     Fluid: imdb.train(imdb.word_dict()) through fluid.DataFeeder with
     LoD, the book's stacked_lstm_net at its published widths (emb 128,
     hid 512, 3 stacked, alternating is_reverse, max pooling), one pass
     of Adam(0.002) at batch 32 on the card, save_inference_model, then
     the runner with LoD offsets within 1e-4 of the card's Executor on
     32 reviews; (c) fit_a_line on uci_housing (batch 32, 8 passes,
     Momentum(0.9, 1e-3)): the last five costs' mean under 0.7 x the
     first five's; (d) mnist.convert through the native RecordWriter,
     read back by common.read_converted and v2.reader.creator: the same
     640 samples in order. flowers, voc2012, v2.image and v2.plot are
     left out (PIL and matplotlib; their parity runs in the CPU tests),
     and the phase says which of PIL, matplotlib and scipy it found;
 45. the utils/ tools and the analyzers, in f32 with TF32 off:
     ImageClassificationDatasetCreater turns 10 classes x 64 seeded 32x32
     JPEGs (4 in 5 to train) into 4 batch files of 128 and a meta file
     with the mean image; MultiProcessImageTransformer(procnum=4), a
     spawn pool made inside this CUDA process, decodes one batch file
     bit-equal to the in-process PILTransformer, then closes;
     predefined_net.small_vgg (image_size 32, 10 classes, colour) with
     training_settings() (batch 128) trains 4 batches on the card through
     the legacy trainer (`run_config`, the provider
     predefined_net.image_data names reading those batches): every cost
     finite; dump_config prints small_vgg's conv ops and simple_conv_net's
     conv and batch_norm ops, make_model_diagram writes a dot graph;
     dump_v2_config writes the topology gzipped and show_pb prints it;
     torch2paddle writes the trained tensors, on the card, to a v2 tar
     that Parameters.from_tar reads back bit-equal; plotcurve.parse_log
     reads the trainer's own "Pass= Batch= AvgCost=" lines (drawn only
     where matplotlib is installed); `python -m paddle_tpu_torch.analysis
     --all` runs in its own interpreter beside the rest and must exit 0,
     its findings logged by code with the baselined count and each
     `# sync-free` root beside the phase that runs it under
     set_sync_debug_mode("error");
 then print the kernels' JSON line (every kernel must have launched on
 a main path; the paged entries also carry their launches in phases
 13, 14, 42 and 43, the flash entries their Fluid launches in phases 18
 and 38, their launches over phase 42 (which must be 0) and in phase
 43 (per rank on the Ulysses path, and the Switch LM's; the dequant
 entries their phase-43 launches over int8 and fp8 pools); no Hopper
 kernel lies on the path of phases 44 and 45 (cuDNN and cuBLAS on the
 card, host C++ in the runner, host tools) or of phases 20-32, whose recurrences, segment
 ops, CTC, loops, beam search, sparse updates, sampled losses,
 convolutions, CRF recursions and detection ops are cuDNN, cuBLAS and
 plain torch ops), then the device line last.

No request count of phases 9, 11 and 13 is cut; phases 10 and 12 run the
trace's first 8 requests.

With --profile, torch.profiler also reads the device-busy share and the
top kernels over the bf16 trace's first steps and steady decode steps,
over 3 train steps, over 24 steps of the serving_quant configuration
with kv_quant none and int8, and over 12 steps of 16 megabatch requests
at K=1 sync and K=8 async, and over 3 Fluid ResNet-50 steps, 3 Fluid
LSTM steps, 3 Fluid NMT training steps, one NMT beam decode, 3 steps of
each phase-25 configuration, 3 Wide&Deep and DeepFM steps, 2 steps of
each phase-30 zoo model (with lrn's forward device time), 3 SRL steps,
3 SSD training steps and one SSD eval step (device time by class and by
region: forward, backward, optimizer).

Tolerances: f32 atol/rtol 1e-4 (reduction order only); bf16 output
atol/rtol 2e-2 against the plain version computed in f32 on the same
bf16 inputs (bf16 rounds the output to ~3 significant digits), for the
flash kernels with atol scaled by the largest |value| (the gradients'
scale varies with the shape); lse (f32 in both) at 1e-4; the f32
training paths at rtol 1e-4 on losses and atol/rtol 1e-4 on parameters.
"""

import functools
import json
import math
import os
import re
import subprocess
import sys
import time

import numpy as np

# H100 SXM published peaks (NVIDIA data sheet): HBM bytes/s and dense
# bf16 tensor-core FLOP/s; float32 outside the tensor cores
HBM_BPS = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
TPU_KERNEL = "paddle_tpu/parallel/paged_attention.py:79"
SOURCE = "paddle_tpu_torch/csrc/paged_attention.cu"
FLASH_SOURCE = "paddle_tpu_torch/csrc/flash_attention.cu"
FLASH_REPLACES = {
    "forward": "paddle_tpu/parallel/flash_attention.py:86",
    "backward_kv": "paddle_tpu/parallel/flash_attention.py:200",
    "backward_q": "paddle_tpu/parallel/flash_attention.py:245",
}
# the port's `# sync-free` roots (paddle_tpu_torch/analysis/trace_lint.py
# lints them statically) and the phase that runs each on the card under
# torch.cuda.set_sync_debug_mode("error")
SYNC_FREE_ROOTS = {
    "paddle_tpu_torch/serving/engine.py::ServingEngine._launch_window":
        "phase 13 (_watch_steady_dispatch: every steady chained dispatch)",
    "paddle_tpu_torch/fluid/core/kernels_rnn.py::_lstm":
        "phase 20 (phase_lstm_sync: the lstm op forward and backward)",
}
# matrix products each flash kernel does per attended (q, k) pair
FLASH_PRODUCTS = {"forward": 2, "backward_kv": 4, "backward_q": 3}

FULL = dict(vocab=32000, dim=512, heads=8, layers=8, max_len=1024)
# phase 42 (the host-bound serving fleet, every bar per layer) runs 4 of
# FULL's 8 layers at its width: the room phase 43 needs within the
# script's 700 s
HALF_DEPTH = dict(FULL, layers=4)
ENGINE = dict(max_slots=16, kv_block_tokens=16, prefill_chunk_tokens=128,
              prefix_cache_tokens=8192)
# the repo's training configuration (bench.py:913-931): tokens [8, 1025]
TRAIN = dict(batch=8, seq=1024, lr=1e-3)


_START = time.monotonic()


def log(*a):
    """Print a line now; a phase's opening line also carries the seconds
    since the script started."""
    if a and str(a[0]).startswith("phase "):
        a = a + ("[%.1f s]" % (time.monotonic() - _START),)
    print(*a, flush=True)


def check(cond, msg):
    """A phase's gate: raise (and so exit non-zero) when it fails."""
    if not cond:
        raise AssertionError(msg)


def gpu_line():
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return res.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------
# phase 2: kernel vs plain version
# ---------------------------------------------------------------------


def _codes(rng, torch, kvq, shape, dev):
    """Random int8 or e4m3 codes of a quantized pool (~N(0, 40) before
    rounding or the cast, clipped to the format's range)."""
    x = 40.0 * rng.randn(*shape).astype(np.float32)
    if kvq == "int8":
        return torch.from_numpy(np.clip(np.round(x), -127, 127)).to(
            dev, torch.int8)
    return torch.from_numpy(np.clip(x, -448, 448)).to(dev).to(
        torch.float8_e4m3fn)


def make_case(rng, torch, dtype, S, R, H, Dh, Bt, MAXB, NB, parked=False,
              base=None, dev="cuda", kvq=None):
    """Random pools, per-slot tables of distinct blocks with a -1 tail
    past each slot's deepest attended depth, and the same tables with
    the tail filled by valid blocks. With `kvq` ("int8" | "fp8") the
    pools hold codes and per-(block, head) scales ks/vs [NB, H] that
    bring the dequantized rows to about N(0, 1)."""
    if kvq is None:
        k = torch.from_numpy(rng.randn(NB, Bt, H, Dh).astype(np.float32))
        v = torch.from_numpy(rng.randn(NB, Bt, H, Dh).astype(np.float32))
        k, v = k.to(dev, dtype), v.to(dev, dtype)
        ks = vs = None
    else:
        k = _codes(rng, torch, kvq, (NB, Bt, H, Dh), dev)
        v = _codes(rng, torch, kvq, (NB, Bt, H, Dh), dev)
        ks, vs = (torch.from_numpy(
            ((0.5 + rng.rand(NB, H)) / 40.0).astype(np.float32)).to(dev)
            for _ in range(2))
    q = torch.from_numpy(rng.randn(S, R, H, Dh).astype(np.float32))
    q = q.to(dev, dtype)
    full = np.stack([rng.choice(NB, MAXB, replace=False)
                     for _ in range(S)]).astype(np.int32)
    if base is None:
        base = rng.randint(0, MAXB * Bt - R + 1, size=S).astype(np.int32)
    base = np.asarray(base, np.int32).reshape(S)
    if parked:
        base[-1] = MAXB * Bt
    part = full.copy()
    for s in range(S):
        need = min(-(-(int(base[s]) + R) // Bt), MAXB)
        part[s, need:] = -1
    t = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
    return dict(q=q, k=k, v=v, ks=ks, vs=vs, part=t(part), full=t(full),
                base=t(base), base_np=base)


def spans_case(rng, torch, dtype, S, shapes, kvq=None, R=4):
    """A verify case in which slot 0's context lies in the split kernel's
    first partition and slot 1's spans them all (its window ends at the
    table's last depth); the other slots' contexts are random."""
    ctx = shapes["MAXB"] * shapes["Bt"]
    base = rng.randint(0, ctx - R + 1, S)
    base[:2] = (5, ctx - R)
    return make_case(rng, torch, dtype, S=S, R=R, base=base, kvq=kvq,
                     **shapes)


# head widths past 64 (each lane of the split kernel accumulates 4 dims)
# and one that is no power of two; quantized pools need a multiple of 16
WIDE = [dict(H=2, Dh=dh, Bt=16, MAXB=8, NB=40) for dh in (128, 40)]
# (wrapper, rows, slots, base) of the windows checked at each wide shape
WIDE_WINDOWS = (("decode", 1, 5, None), ("verify", 4, 5, None),
                ("prefill", 20, 1, [37]))


def check_wide(torch, tpa, rng, dtype, kvq=None):
    """check_case on a decode (with a parked row), verify and prefill
    window at each WIDE shape the pool type takes."""
    name = "%s q %s" % (kvq or "none", str(dtype).split(".")[-1])
    for shapes in WIDE:
        if kvq is not None and shapes["Dh"] % 16:
            continue
        for which, R, S, base in WIDE_WINDOWS:
            check_case(torch, tpa, which, make_case(
                rng, torch, dtype, S=S, R=R, base=base,
                parked=which == "decode", kvq=kvq, **shapes),
                "%s %s Dh=%d R=%d" % (which, name, shapes["Dh"], R))


def attended_tokens(c, R, Bt, MAXB):
    return [min(int(b) + r + 1, MAXB * Bt) for b in c["base_np"]
            for r in range(R)]


def run_wrapper(tpa, which, c, table, plain=False, parts=None):
    """Call one wrapper (or the plain version on f32 copies of q and
    unquantized pools; quantized pools pass their codes and scales as
    they are; with `parts`, the split plain version at that partition
    count) on a case."""
    q, k, v, base = c["q"], c["k"], c["v"], c["base"]
    sc = dict(k_scale=c["ks"], v_scale=c["vs"])
    if plain:
        if c["ks"] is None:
            k, v = k.float(), v.float()
        scale = 1.0 / math.sqrt(q.shape[-1])
        if parts is None:
            fn = tpa.paged_attention_plain
        else:
            fn = functools.partial(tpa.paged_attention_split_plain,
                                   parts=parts)
        out = fn(q.float(), k, v, table, base, scale=scale,
                 scale_in_q=which != "decode", **sc)
        return out[:, 0] if which == "decode" else (
            out[0] if which == "prefill" else out)
    if which == "decode":
        return tpa.paged_decode_attention(q[:, 0], k, v, table, base, **sc)
    if which == "verify":
        return tpa.paged_verify_attention(q, k, v, table, base, **sc)
    return tpa.paged_prefill_attention(q[0], k, v, table[0],
                                       int(c["base_np"][0]), **sc)


def case_parts(tpa, which, c):
    """The split kernel's partition count for a case's wrapper call."""
    q, k, table = c["q"], c["k"], c["part"]
    S, R = (1, q.shape[1]) if which == "prefill" else (q.shape[0],
                                                       q.shape[1])
    return tpa.split_parts(S, R, q.shape[2], k.shape[1], table.shape[1])


def check_case(torch, tpa, which, c, label):
    """The wrapper vs the plain version (and for bf16 q, the split
    kernel vs the split plain version at its partition count, and a
    relaunch bit-identical); a -1 table tail bit-identical to a full
    table."""
    tol = 1e-4 if c["q"].dtype == torch.float32 else 2e-2
    got = run_wrapper(tpa, which, c, c["part"])
    got_full = run_wrapper(tpa, which, c, c["full"])
    split = c["q"].dtype == torch.bfloat16 and got.is_cuda
    if split:
        again = run_wrapper(tpa, which, c, c["part"])
    if got.is_cuda:
        torch.cuda.synchronize()  # a fault in the kernel surfaces here
    want = run_wrapper(tpa, which, c, c["part"], plain=True)
    err = float((got.float() - want).abs().max())
    ok = torch.allclose(got.float(), want, atol=tol, rtol=tol)
    same = torch.equal(got, got_full)
    note = ""
    if split:
        parts = case_parts(tpa, which, c)
        want_s = run_wrapper(tpa, which, c, c["part"], plain=True,
                             parts=parts)
        err_s = float((got.float() - want_s).abs().max())
        ok = ok and torch.allclose(got.float(), want_s, atol=tol, rtol=tol)
        same = same and torch.equal(got, again)
        note = "; %d partitions, vs split plain %.3e, relaunch" % (parts,
                                                                   err_s)
    log("  %-34s max_abs_err %.3e (tol %.0e) %s; -1 tail%s bit-identical: "
        "%s" % (label, err, tol, "ok" if ok else "FAIL", note, same))
    if not (ok and same and torch.isfinite(got).all()):
        raise AssertionError("kernel disagrees with its plain version: "
                             + label)
    return err


def time_ms(torch, fn, iters=30):
    """Mean device ms per call with a cold L2: a 64 MiB buffer is
    rewritten before each timed call, as the serving step finds the pool
    (8 layers x 32 MiB) cold. A GPU spin queued first keeps the device
    busy while the host enqueues the call, so the events bracket device
    time, not the wrapper's Python."""
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    for _ in range(3):
        fn()
    total = 0.0
    for _ in range(iters):
        torch.cuda._sleep(4_000_000)  # ~2 ms of device spin
        flush.zero_()
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        e1.synchronize()
        total += e0.elapsed_time(e1)
    return total / iters


def bound_ms(c, tokens, dtype_name):
    """Least time for the same work: each input byte read once (the K/V
    rows attended at the pool's storage size, a quantized pool's scales
    of the attended blocks, q, tables, positions), the output written
    once, vs 4*Dh flops per (row, head, attended depth) at q's peak
    rate."""
    q = c["q"]
    H, Dh = q.shape[2], q.shape[3]
    esize = q.element_size()
    uniq = {}  # K/V rows are shared by a slot's window rows
    R = q.shape[1]
    for i, t in enumerate(tokens):
        s = i // R
        uniq[s] = max(uniq.get(s, 0), t)
    kv = sum(uniq.values()) * H * Dh * 2 * c["k"].element_size()
    if c["ks"] is not None:
        Bt = c["k"].shape[1]
        kv += sum(-(-n // Bt) for n in uniq.values()) * H * 4 * 2
    qo = 2 * q.numel() * esize
    meta = c["part"].numel() * 4 + c["base"].numel() * 4
    flops = sum(tokens) * H * 4 * Dh
    t_bytes = (kv + qo + meta) / HBM_BPS * 1e3
    t_ops = flops / PEAK_FLOPS[dtype_name] * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops
            else "operations")


def kernel_device_ms(torch, fn, names, n=20):
    """Mean device ms per launch of each CUDA kernel whose name holds one
    of `names`, from torch.profiler over n calls of fn (over the launches
    the profiler recorded; None where it recorded none)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    us, count = {}, {}
    for e in prof.key_averages():
        if getattr(e, "device_type", None) != DeviceType.CUDA:
            continue
        for name in names:
            if name in e.key and _device_us(e) > 0:
                us[name] = us.get(name, 0.0) + _device_us(e)
                count[name] = count.get(name, 0) + e.count
    return {name: us[name] / count[name] / 1e3 if count.get(name) else None
            for name in names}


def time_case(torch, tpa, which, c, label):
    """Kernel and plain-version device ms with a cold L2, and the bound;
    for bf16 q also the split plain version's time and the partition
    count, and the call itself (`call`) for phase 19, which reads each of
    its two kernels' device time."""
    R, Bt, MAXB = c["q"].shape[1], c["k"].shape[1], c["part"].shape[1]
    ms = time_ms(torch, lambda: run_wrapper(tpa, which, c, c["part"]))
    plain = time_ms(torch, lambda: run_wrapper(tpa, which, c, c["part"],
                                               plain=True), iters=10)
    b, by = bound_ms(c, attended_tokens(c, R, Bt, MAXB),
                     str(c["q"].dtype).split(".")[-1])
    res = dict(ms=ms, plain_ms=plain, bound_ms=b, bound_by=by)
    note = ""
    if c["q"].dtype == torch.bfloat16:
        parts = case_parts(tpa, which, c)
        res["partitions"] = parts
        res["shared_bytes"] = tpa.split_shared_bytes(c["k"].dtype, R,
                                                     c["q"].shape[3])
        res["split_plain_ms"] = time_ms(torch, lambda: run_wrapper(
            tpa, which, c, c["part"], plain=True, parts=parts), iters=10)
        res["label"] = "%s %s" % (which, label)
        res["call"] = lambda: run_wrapper(tpa, which, c, c["part"])
        note = "; %d partitions, %d B shared, split plain %.4f ms" % (
            parts, res["shared_bytes"], res["split_plain_ms"])
    log("  %-8s %-10s kernel %.4f ms, plain %.4f ms, bound %.4f ms (%s)%s; "
        "no single PyTorch call computes paged attention"
        % (which, label, ms, plain, b, by, note))
    return res


# the two CUDA kernels of a bf16 paged wrapper call
PAGED_KERNELS = ("paged_split_kernel", "paged_merge_kernel")


def phase_split_times(torch, records):
    """Phase 13: the split and merge kernels' device time (torch.profiler,
    warm L2) of every bf16 call time_case timed, into its record. A
    profiler window slows the host work of every later phase, so this
    runs once the other phases are done."""
    for res in records:
        if "call" not in res:
            continue
        dev = kernel_device_ms(torch, res.pop("call"), PAGED_KERNELS)
        res["split_kernel_ms"] = dev["paged_split_kernel"]
        res["merge_kernel_ms"] = dev["paged_merge_kernel"]
        log("  %-18s %d partitions: split kernel %s ms + merge %s ms "
            "(kernel call %.4f ms with a cold L2)"
            % (res["label"], res["partitions"],
               *("not measured" if x is None else "%.4f" % x
                 for x in (res["split_kernel_ms"], res["merge_kernel_ms"])),
               res["ms"]))


# the paged pools at the serving shapes with 16-token blocks: phase 3's
# engine and phase 11's spec engine (SPEC_ENGINE)
SPEC_SHAPES = dict(H=8, Dh=64, Bt=16, MAXB=64, NB=1024)


def phase_kernels(torch, tpa):
    rng = np.random.RandomState(0)
    shapes = SPEC_SHAPES
    errs, timing = {}, {}
    for dtype in (torch.bfloat16, torch.float32):
        name = str(dtype).split(".")[-1]
        cases = {
            "decode": make_case(rng, torch, dtype, S=16, R=1, parked=True,
                                **shapes),
            # the spec phase's verify shape: 32 slots, a 4-row window
            "verify": make_case(rng, torch, dtype, S=32, R=4, **shapes),
            "prefill": make_case(rng, torch, dtype, S=1, R=128, base=[256],
                                 **shapes),
        }
        for which, c in cases.items():
            errs[(which, name)] = check_case(
                torch, tpa, which, c, "%s %s full width" % (which, name))
        check_case(torch, tpa, "verify", spans_case(
            np.random.RandomState(1), torch, dtype, 16, shapes),
            "verify %s one and all partitions" % name)
        if dtype == torch.bfloat16:
            for which, c in cases.items():
                timing[which] = time_case(torch, tpa, which, c, "bf16")
    odd = dict(H=4, Dh=32, Bt=8, MAXB=16, NB=60)
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[-1]
        check_case(torch, tpa, "decode", make_case(
            rng, torch, dtype, S=5, R=1, parked=True, **odd),
            "decode %s Dh=32 Bt=8" % name)
        check_case(torch, tpa, "verify", make_case(
            rng, torch, dtype, S=5, R=3, **odd),
            "verify %s Dh=32 Bt=8 R=3" % name)
        check_case(torch, tpa, "prefill", make_case(
            rng, torch, dtype, S=1, R=13, base=[21], **odd),
            "prefill %s Dh=32 Bt=8 C=13" % name)
        check_wide(torch, tpa, np.random.RandomState(2), dtype)
    return errs, timing


def phase_kernels_quant(torch, tpa):
    """The dequant branch: all three wrappers over int8 and fp8 pools with
    q in bf16 and f32 at the serving_quant shapes (H 8, Dh 64, Bt 32, 32
    slots, contexts up to 1024, a 128-row chunk at start 256, a 4-row
    verify window), at one odd shape (Dh 32, Bt 16, R 3), at Dh 128 and
    on a verify case whose slots' contexts lie in one partition and span
    them all; then bf16 timings with a cold L2 of every wrapper over
    int8, fp8 and (the unquantized kernel at the same shape) bf16 pools.
    Last, the verify wrapper over int8 and fp8 pools at the spec
    engine's shape (Bt 16, 64 table entries, a parked row), where phase
    11 launches it, checked in bf16 and f32 and timed in bf16."""
    rng = np.random.RandomState(3)
    shapes = dict(H=8, Dh=64, Bt=32, MAXB=32, NB=1024)
    odd = dict(H=4, Dh=32, Bt=16, MAXB=16, NB=60)
    errs, timing = {}, {}
    for kvq in (None, "int8", "fp8"):
        kname = kvq or "none"
        for dtype in (torch.bfloat16, torch.float32):
            name = str(dtype).split(".")[-1]
            cases = {
                "decode": make_case(rng, torch, dtype, S=32, R=1,
                                    parked=True, kvq=kvq, **shapes),
                "verify": make_case(rng, torch, dtype, S=32, R=4, kvq=kvq,
                                    **shapes),
                "prefill": make_case(rng, torch, dtype, S=1, R=128,
                                     base=[256], kvq=kvq, **shapes),
            }
            for which, c in cases.items():
                errs[(which, kname, name)] = check_case(
                    torch, tpa, which, c, "%s %s q %s Bt=32" % (
                        which, kname, name))
            if kvq is not None:
                for which, R, S, base in (("decode", 1, 5, None),
                                          ("verify", 3, 5, None),
                                          ("prefill", 13, 1, [21])):
                    check_case(torch, tpa, which, make_case(
                        rng, torch, dtype, S=S, R=R, base=base,
                        parked=which == "decode", kvq=kvq, **odd),
                        "%s %s q %s Dh=32 Bt=16 R=%d" % (which, kname, name,
                                                         R))
                check_case(torch, tpa, "verify", spans_case(
                    np.random.RandomState(4), torch, dtype, 32, shapes,
                    kvq=kvq), "verify %s q %s one and all partitions"
                    % (kname, name))
                check_wide(torch, tpa, np.random.RandomState(6), dtype,
                           kvq=kvq)
            if dtype == torch.bfloat16:
                for which, c in cases.items():
                    timing[(which, kname)] = time_case(
                        torch, tpa, which, c, "%s pool" % kname)
    # the verify launches run under spec decoding at SPEC_ENGINE's shape
    # (Bt 16, MAXB 64): phase 2's verify case for the unquantized pool
    for kvq in ("int8", "fp8"):
        for dtype in (torch.bfloat16, torch.float32):
            name = str(dtype).split(".")[-1]
            c = make_case(rng, torch, dtype, S=32, R=4, parked=True, kvq=kvq,
                          **SPEC_SHAPES)
            errs[("verify_spec", kvq, name)] = check_case(
                torch, tpa, "verify", c, "verify %s q %s Bt=16 (spec)"
                % (kvq, name))
            if dtype == torch.bfloat16:
                timing[("verify_spec", kvq)] = time_case(
                    torch, tpa, "verify", c, "%s Bt16" % kvq)
    return errs, timing


# ---------------------------------------------------------------------
# phases 3-4: the serving engine at full width
# ---------------------------------------------------------------------


def trace(cfg, n=12, seed=0):
    rng = np.random.RandomState(seed)
    header = rng.randint(0, cfg.vocab, 128).astype(np.int32)
    reqs = []
    for i in range(n):
        T0 = int(rng.randint(64, 513))
        if T0 >= 160:  # the shared header leads every long prompt
            tail = rng.randint(0, cfg.vocab, T0 - 128).astype(np.int32)
            prompt = np.concatenate([header, tail])
        else:
            prompt = rng.randint(0, cfg.vocab, T0).astype(np.int32)
        reqs.append(dict(prompt=prompt,
                         max_new_tokens=int(rng.randint(32, 129)),
                         temperature=0.8 if i % 3 == 1 else 0.0,
                         seed=1000 + i, publish_len=128))
    # a whole-block prompt served twice: the resubmit aliases every
    # block and copies the last one on write
    cow = np.concatenate(
        [header, rng.randint(0, cfg.vocab, 128).astype(np.int32)])
    reqs.append(dict(prompt=cow, max_new_tokens=32, seed=7))
    reqs.append(dict(prompt=cow, max_new_tokens=32, seed=7))
    return reqs


def _sync(torch, dev):
    if dev == "cuda":
        torch.cuda.synchronize()


def phase_serve(torch, T, tpa, ServingEngine, params, cfg, dev="cuda"):
    warm = ServingEngine(params, cfg, device=dev, **ENGINE)
    warm.submit(np.arange(40) % cfg.vocab, 4)
    warm.run()
    del warm
    eng = ServingEngine(params, cfg, device=dev, **ENGINE)
    reqs = trace(cfg)
    _sync(torch, dev)
    zero_launches(tpa)
    t0 = time.monotonic()
    hs = [eng.submit(**r) for r in reqs[:-1]]
    eng.run()
    hs.append(eng.submit(**reqs[-1]))  # after the first copy published
    eng.run()
    _sync(torch, dev)
    wall = time.monotonic() - t0
    launches = read_launches(tpa)
    rep = eng.metrics.report()
    check(all(h.done for h in hs), "a request did not finish")
    for h in hs:
        check(h.finish_reason in ("budget", "eos"),
              "request %d finished %r" % (h.rid, h.finish_reason))
        check(all(0 <= t < cfg.vocab for t in h.tokens),
              "request %d emitted a token outside the vocab" % h.rid)
        if h.finish_reason == "budget":
            check(len(h.tokens) == h.max_new_tokens,
                  "request %d stopped short of its budget" % h.rid)
    want_dec = cfg.layers * rep["decode_steps"]
    want_pre = cfg.layers * rep["prefill_chunks"]
    log("  launches: decode %d (layers x decode steps = %d), prefill %d "
        "(layers x chunks = %d), verify %d"
        % (launches["decode"], want_dec, launches["prefill"], want_pre,
           launches["verify"]))
    if dev == "cuda":
        check(launches["decode"] == want_dec and want_dec > 0,
              "decode kernel launches != layers x decode steps")
        check(launches["prefill"] == want_pre and want_pre > 0,
              "prefill kernel launches != layers x prefill chunks")
    check(rep["prefix_cache"]["hits"] >= 1 and rep["cow_blocks"] >= 1,
          "the trace made no prefix hit or no copy-on-write")
    toks = rep["tokens_out"]
    log("  served %d requests, %d tokens in %.3f s: %.1f tokens/s; TTFT "
        "mean %.4f s max %.4f s; decode steps %d (mean occupancy %.3f); "
        "prefill chunks %d; prefix hits %d, cow blocks %d"
        % (len(hs), toks, wall, toks / wall, rep["mean_ttft_s"],
           max(h.ttft_s for h in hs), rep["decode_steps"],
           rep["mean_occupancy"], rep["prefill_chunks"],
           rep["prefix_cache"]["hits"], rep["cow_blocks"]))
    eng.metrics.print_report()
    return launches, dict(tokens_per_s=toks / wall, wall_s=wall,
                          tokens=toks, mean_ttft_s=rep["mean_ttft_s"],
                          decode_steps=rep["decode_steps"],
                          prefill_chunks=rep["prefill_chunks"])


def phase_generate(torch, T, ServingEngine, params, cfg, dev="cuda"):
    p32 = _tree_map(lambda t: t.float(), params)
    cfg32 = T.TransformerConfig(vocab=cfg.vocab, dim=cfg.dim,
                                heads=cfg.heads, layers=cfg.layers,
                                max_len=cfg.max_len)
    reqs = trace(cfg32, n=4, seed=1)[:4]
    for r in reqs:
        r.update(temperature=0.0, max_new_tokens=min(r["max_new_tokens"],
                                                      48))
    oracle = []
    for r in reqs:
        p = torch.from_numpy(r["prompt"][None]).long().to(dev)
        oracle.append(T.generate(p32, p, cfg32, r["max_new_tokens"])
                      [0, len(r["prompt"]):].tolist())
    # the last request retires on EOS: its 5th greedy token
    eos = oracle[-1][4]
    reqs[-1]["eos_id"] = eos
    oracle[-1] = oracle[-1][:oracle[-1].index(eos) + 1]
    # a pool two blocks over the largest request's worst case: the four
    # requests cannot all hold their reservations at once
    blocks = 2 + max(-(-(len(r["prompt"]) + r["max_new_tokens"]) // 16)
                     for r in reqs)
    eng = ServingEngine(p32, cfg32, device=dev, max_slots=4,
                        kv_block_tokens=16, prefill_chunk_tokens=128,
                        prefix_cache_tokens=8192, kv_pool_blocks=blocks)
    hs = [eng.submit(**r) for r in reqs]
    held = False
    while eng.step():
        held |= bool(eng.queue_depth
                     and eng.live_slots + eng.prefilling_slots < 4)
    for h, want in zip(hs, oracle):
        if h.tokens != want:
            raise AssertionError("f32 engine diverged from generate() for "
                                 "request %d: %s vs %s"
                                 % (h.rid, h.tokens[:16], want[:16]))
    check(hs[-1].finish_reason == "eos", "the EOS request did not retire "
          "on EOS")
    log("  f32 engine == generate() for %d requests (%d tokens); EOS "
        "retirement ok; backpressure (queued beside a free slot): %s"
        % (len(hs), sum(len(w) for w in oracle), held))
    check(held, "the small pool did not hold a request back")


# ---------------------------------------------------------------------
# phases 9-12: quantized serving and speculative decoding at full width
# ---------------------------------------------------------------------

# the repo's serving_quant configuration at its chip shape
# (bench.py:1783-1808) and serving_fused (bench.py:1553-1562): the model
# above with 32 slots and 128-token chunks over an 8192-token prefix
# cache; 32-token blocks for the quantized pools, 16 under spec decode
QUANT_ENGINE = dict(max_slots=32, kv_block_tokens=32,
                    prefill_chunk_tokens=128, prefix_cache_tokens=8192)
SPEC_ENGINE = dict(max_slots=32, kv_block_tokens=16,
                   prefill_chunk_tokens=128, prefix_cache_tokens=8192,
                   spec_draft_len=4)
# bench.py's trace: Poisson arrivals at 2 per step (seed 0), a 128-token
# shared header, 32-128 suffix tokens, 32-96 new tokens, all greedy
POISSON = dict(n=64, header=128, t_lo=32, t_hi=128, n_lo=32, n_hi=96,
               rate=2.0)


def poisson_trace(vocab, seed=0):
    """bench.py's serving trace: [(prompt, max_new)] and arrival steps."""
    p = POISSON
    rng = np.random.RandomState(seed)
    header = rng.randint(0, vocab, p["header"]).astype(np.int32)
    arrive = np.floor(np.cumsum(
        rng.exponential(1.0 / p["rate"], p["n"]))).astype(int)
    reqs = [(np.concatenate([header, rng.randint(
        0, vocab, int(rng.randint(p["t_lo"], p["t_hi"] + 1))).astype(
            np.int32)]), int(rng.randint(p["n_lo"], p["n_hi"] + 1)))
        for _ in range(p["n"])]
    return reqs, arrive


def run_poisson(torch, eng, reqs, arrive, dev="cuda"):
    """bench.py's open-loop submission: a request enters at its arrival
    step, and an idle engine jumps to the next arrival. Returns (handles,
    wall seconds ending in a device sync, peak resident slots)."""
    hs, peak = [], 0
    t0 = time.monotonic()
    i = step = 0
    while i < len(reqs) or eng.live_slots or eng.queue_depth \
            or eng.prefilling_slots:
        while i < len(reqs) and arrive[i] <= step:
            prompt, n = reqs[i]
            hs.append(eng.submit(prompt, n, publish_len=POISSON["header"]))
            i += 1
        if not eng.step() and i < len(reqs):
            step = max(step + 1, int(arrive[i]))
            continue
        peak = max(peak, eng.live_slots + eng.prefilling_slots)
        step += 1
    _sync(torch, dev)
    return hs, time.monotonic() - t0, peak


def greedy_agreement(outs, ref):
    """bench.py:1697-1711: mean greedy-prefix agreement of `outs` with
    `ref`, the longest common prefix over the longer length."""
    num = den = 0
    for a, b in zip(outs, ref):
        m = 0
        while m < min(len(a), len(b)) and a[m] == b[m]:
            m += 1
        num += m
        den += max(len(a), len(b))
    return num / den if den else 1.0


def zero_launches(tpa):
    for key in tpa.launches:
        tpa.launches[key] = 0


def read_launches(tpa):
    return dict(tpa.launches)


def check_served(hs, vocab):
    check(all(h.done for h in hs), "a request did not finish")
    for h in hs:
        check(h.finish_reason == "budget" and
              len(h.tokens) == h.max_new_tokens,
              "request %d finished %r after %d tokens"
              % (h.rid, h.finish_reason, len(h.tokens)))
        check(all(0 <= t < vocab for t in h.tokens),
              "request %d emitted a token outside the vocab" % h.rid)


def _serve_run(torch, tpa, ServingEngine, params, cfg, kw, reqs, arrive,
               dev):
    """One warmed engine over the trace with the paged counters zeroed
    just before and read just after: (engine, handles, wall, peak,
    launches)."""
    warm = ServingEngine(params, cfg, device=dev, **kw)
    warm.submit(np.arange(40) % cfg.vocab, 4)
    warm.run()
    del warm
    eng = ServingEngine(params, cfg, device=dev, **kw)
    _sync(torch, dev)
    zero_launches(tpa)
    hs, wall, peak = run_poisson(torch, eng, reqs, arrive, dev)
    launches = read_launches(tpa)
    check_served(hs, cfg.vocab)
    return eng, hs, wall, peak, launches


def phase_serve_quant(torch, T, tpa, ServingEngine, params, cfg,
                      dev="cuda", n=None):
    """Phase 9: the serving_quant trace at one KV byte budget, (max_len //
    Bt) unquantized blocks, through kv_quant none / int8 / fp8 and
    weight_quant int8 at the unquantized pool. Each run's decode and
    prefill launches equal layers x steps; int8 holds strictly more
    resident slots than none; greedy-prefix agreement with the none run
    is reported."""
    reqs, arrive = poisson_trace(cfg.vocab)
    reqs, arrive = reqs[:n], arrive[:n]
    Bt, dh = QUANT_ENGINE["kv_block_tokens"], cfg.dim // cfg.heads
    item = params["embed"].element_size()
    budget = (cfg.max_len // Bt) * T.kv_block_bytes(
        cfg.layers, cfg.heads, dh, Bt, "none", act_itemsize=item)
    out, ref = {}, None
    for name, kvq, wq in (("none", "none", None), ("int8", "int8", None),
                          ("fp8", "fp8", None),
                          ("weight_int8", "none", "int8")):
        bb = T.kv_block_bytes(cfg.layers, cfg.heads, dh, Bt, kvq,
                              act_itemsize=item)
        blocks = max(1, budget // bb)
        kw = dict(QUANT_ENGINE, kv_pool_blocks=blocks, kv_quant=kvq,
                  weight_quant=wq)
        eng, hs, wall, peak, launches = _serve_run(
            torch, tpa, ServingEngine, params, cfg, kw, reqs, arrive, dev)
        rep = eng.metrics.report()
        check(rep["kv_quant"] == kvq and rep["weight_quant"] == wq,
              "%s run reports kv_quant %r weight_quant %r"
              % (name, rep["kv_quant"], rep["weight_quant"]))
        want_dec = cfg.layers * rep["decode_steps"]
        want_pre = cfg.layers * rep["prefill_chunks"]
        if dev == "cuda":
            check(launches["decode"] == want_dec > 0 and
                  launches["prefill"] == want_pre > 0 and
                  launches["verify"] == 0,
                  "%s launches %s != layers x steps (decode %d, prefill "
                  "%d)" % (name, launches, want_dec, want_pre))
        outs = [list(h.tokens) for h in hs]
        ref = outs if ref is None else ref
        toks = rep["tokens_out"]
        out[name] = dict(
            launches=launches, slots_resident=peak, kv_pool_blocks=blocks,
            kv_block_bytes=bb, agreement_vs_none=greedy_agreement(outs, ref),
            tokens=toks, wall_s=wall, tokens_per_s=toks / wall,
            decode_steps=rep["decode_steps"],
            prefill_chunks=rep["prefill_chunks"],
            prefix_hits=rep["prefix_cache"]["hits"],
            cow_blocks=rep["cow_blocks"])
        log("  %-11s pool %d blocks of %d B: %d slots resident (peak), "
            "agreement vs none %.4f, %d tokens in %.3f s = %.1f tokens/s; "
            "decode steps %d, chunks %d; launches %s; prefix hits %d"
            % (name, blocks, bb, peak, out[name]["agreement_vs_none"], toks,
               wall, toks / wall, rep["decode_steps"], rep["prefill_chunks"],
               launches, rep["prefix_cache"]["hits"]))
    check(out["int8"]["slots_resident"] > out["none"]["slots_resident"],
          "int8 KV did not hold more resident slots than none at the byte "
          "budget: %d <= %d" % (out["int8"]["slots_resident"],
                                out["none"]["slots_resident"]))
    return out


def phase_quant_identity(torch, T, ServingEngine, p32, cfg32, dev="cuda",
                         n=8):
    """Phase 10: f32, the first `n` requests of the trace: a quantized
    engine through the kernel (paged_kernel="fused") emits the greedy
    tokens of one through the plain gathered-view math ("gather"), for
    int8 and fp8."""
    reqs, arrive = poisson_trace(cfg32.vocab)
    reqs, arrive = reqs[:n], arrive[:n]
    for kvq in ("int8", "fp8"):
        toks = {}
        for pk in ("fused", "gather"):
            eng = ServingEngine(p32, cfg32, device=dev, paged_kernel=pk,
                                kv_quant=kvq, **QUANT_ENGINE)
            hs, _, _ = run_poisson(torch, eng, reqs, arrive, dev)
            check_served(hs, cfg32.vocab)
            toks[pk] = [list(h.tokens) for h in hs]
        same = toks["fused"] == toks["gather"]
        log("  %s f32: kernel tokens == gather tokens for %d requests (%d "
            "tokens): %s" % (kvq, n, sum(map(len, toks["fused"])), same))
        check(same, "%s: fused tokens differ from gather tokens" % kvq)


def phase_spec(torch, T, tpa, ServingEngine, params, cfg, dev="cuda",
               n=None):
    """Phase 11: the serving_fused trace with spec_draft_len 4 over
    kv_quant none / int8 / fp8 in bf16, after the same trace through
    plain decode (kv_quant none) for comparison. Verify launches equal
    layers x verify steps and decode launches 0 (plain decode: decode
    launches layers x decode steps, verify 0); prefill launches layers x
    chunks."""
    reqs, arrive = poisson_trace(cfg.vocab)
    reqs, arrive = reqs[:n], arrive[:n]
    out = {}
    for kvq, spec in (("plain", None), ("none", 4), ("int8", 4),
                      ("fp8", 4)):
        eng, hs, wall, peak, launches = _serve_run(
            torch, tpa, ServingEngine, params, cfg,
            dict(SPEC_ENGINE, spec_draft_len=spec,
                 kv_quant="none" if spec is None else kvq),
            reqs, arrive, dev)
        rep = eng.metrics.report()
        steps = rep["decode_steps"]
        want = {"verify": cfg.layers * steps if spec else 0,
                "decode": 0 if spec else cfg.layers * steps,
                "prefill": cfg.layers * rep["prefill_chunks"]}
        if dev == "cuda":
            check(launches == want and steps > 0,
                  "%s launches %s != %s" % (kvq, launches, want))
        toks = rep["tokens_out"]
        out[kvq] = dict(launches=launches, tokens=toks, wall_s=wall,
                        tokens_per_s=toks / wall,
                        steps=steps,
                        accept_rate=rep["spec_accept_rate"],
                        spec_drafted=rep["spec_drafted"],
                        spec_accepted=rep["spec_accepted"],
                        slots_resident=peak)
        log("  %-15s %d tokens in %.3f s = %.1f tokens/s; steps %d, "
            "accept rate %s (%d of %d drafts); launches %s"
            % ("plain decode:" if spec is None else "spec K=4 %s:" % kvq,
               toks, wall, toks / wall, steps, rep["spec_accept_rate"],
               rep["spec_accepted"], rep["spec_drafted"], launches))
    return out


def phase_spec_identity(torch, T, ServingEngine, p32, cfg32, dev="cuda",
                        n=8):
    """Phase 12: f32, the first `n` requests: spec decode emits the plain
    decode's tokens for kv_quant none and int8 (the row-commit rule keeps
    rejected drafts out of every block scale)."""
    reqs, arrive = poisson_trace(cfg32.vocab)
    reqs, arrive = reqs[:n], arrive[:n]
    for kvq in ("none", "int8"):
        toks = {}
        for spec in (None, 4):
            eng = ServingEngine(p32, cfg32, device=dev, kv_quant=kvq,
                                **dict(SPEC_ENGINE, spec_draft_len=spec))
            hs, _, _ = run_poisson(torch, eng, reqs, arrive, dev)
            check_served(hs, cfg32.vocab)
            toks[spec] = [list(h.tokens) for h in hs]
        same = toks[4] == toks[None]
        log("  %s f32: spec tokens == plain tokens for %d requests (%d "
            "tokens): %s" % (kvq, n, sum(map(len, toks[None])), same))
        check(same, "%s: spec tokens differ from plain tokens" % kvq)


# ---------------------------------------------------------------------
# phases 13-15: decode windows, adapters, fingerprints and the KV store
# ---------------------------------------------------------------------

# bench_serving_megabatch's configuration at its chip shape
# (bench.py:1093-1180): 16 slots, 64 requests arriving Poisson at 1 per
# step (seed 0), prompts of 64-512 tokens, 128 new tokens each, even
# requests greedy and odd ones sampled at T 0.8
MEGABATCH = dict(slots=16, n=64, rate=1.0, p_lo=64, p_hi=512, budget=128)
WINDOWS = ((1, False), (1, True), (4, False), (4, True), (8, False),
           (8, True))


def megabatch_trace(vocab, seed=0):
    """bench.py's megabatch trace: [(prompt, max_new, temperature)] and
    arrival steps, drawn in bench.py's order."""
    m = MEGABATCH
    rng = np.random.RandomState(seed)
    arrive = np.floor(np.cumsum(
        rng.exponential(1.0 / m["rate"], m["n"]))).astype(int)
    reqs = [(rng.randint(0, vocab, rng.randint(m["p_lo"], m["p_hi"] + 1))
             .astype(np.int32), m["budget"], 0.0 if j % 2 == 0 else 0.8)
            for j in range(m["n"])]
    return reqs, arrive


def _watch_steady_dispatch(torch, eng, dev):
    """Wrap the engine's window launch: a steady chained launch (chained
    off the pending window, no band dirty) runs under
    torch.cuda.set_sync_debug_mode("error"), so any synchronising call
    in it raises. Returns the list of steady launches seen."""
    steady = []
    real = eng._launch_window

    def launch(prev, live):
        if prev is None or eng._dirty or dev != "cuda":
            return real(prev, live)
        up0 = eng.metrics.band_uploads
        torch.cuda.set_sync_debug_mode("error")
        try:
            rec = real(prev, live)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        check(eng.metrics.band_uploads == up0,
              "a steady chained dispatch uploaded a band")
        steady.append(1)
        return rec

    eng._launch_window = launch
    return steady


def _megabatch_run(torch, tpa, ServingEngine, params, cfg, reqs, arrive,
                   dev, **kw):
    """One variant over the megabatch trace after an unmeasured warm-up
    request, with the paged counters zeroed just before the trace and
    read just after; returns the per-request tokens and the run's
    numbers (deltas over the trace)."""
    eng = ServingEngine(params, cfg, max_slots=MEGABATCH["slots"],
                        device=dev, **kw)
    eng.submit(np.arange(1, 9, dtype=np.int32), 4)
    eng.run()
    steady = _watch_steady_dispatch(torch, eng, dev)
    m0 = dict(eng.metrics.report())
    busy0 = eng.metrics.device_busy_s
    _sync(torch, dev)
    zero_launches(tpa)
    hs, i, step = [], 0, 0
    t0 = time.monotonic()
    while i < len(reqs) or eng.live_slots or eng.queue_depth \
            or eng.prefilling_slots or eng._inflight is not None:
        while i < len(reqs) and arrive[i] <= step:
            p, n, temp = reqs[i]
            hs.append(eng.submit(p, n, temperature=temp, seed=1000 + i))
            i += 1
        if not eng.step() and i < len(reqs):
            step = max(step + 1, int(arrive[i]))  # idle gap: jump
            continue
        step += 1
    _sync(torch, dev)
    wall = time.monotonic() - t0
    launches = read_launches(tpa)
    check_served(hs, cfg.vocab)
    rep = eng.metrics.report()
    toks = rep["tokens_out"] - m0["tokens_out"]
    d = {k: rep[k] - m0[k] for k in ("decode_steps", "prefill_chunks",
                                     "band_uploads")}
    busy = eng.metrics.device_busy_s - busy0
    return [list(h.tokens) for h in hs], dict(
        d, launches=launches, tokens=toks, wall_s=wall,
        tokens_per_s=toks / wall, steps_per_token=d["decode_steps"] / toks,
        host_share_outside_dispatch_sync=max(0.0, wall - busy) / wall,
        steady_chained_dispatches=len(steady))


def _check_window_launches(cfg, K, r, label, dev):
    want = {"decode": cfg.layers * K * r["decode_steps"],
            "prefill": cfg.layers * r["prefill_chunks"], "verify": 0}
    if dev == "cuda":
        check(r["launches"] == want and r["decode_steps"] > 0,
              "%s launches %s != %s (decode = layers x K x windows)"
              % (label, r["launches"], want))


def phase_windows(torch, T, tpa, ServingEngine, params, cfg, dev="cuda",
                  n=None, quant_n=16):
    """Phase 13: the megabatch trace through decode_window K in {1, 4, 8},
    sync and async: every variant's tokens equal K=1 sync's; decode
    launches = layers x K x windows, prefill launches = layers x chunks;
    with async, the steady chained dispatches run under
    set_sync_debug_mode("error") and at least one runs. Then the first
    `quant_n` requests over int8 and fp8 pools, K=8 async against K=1
    sync (kernel 4b on the window path)."""
    reqs, arrive = megabatch_trace(cfg.vocab)
    reqs, arrive = reqs[:n], arrive[:n]
    out, base = {}, None
    for K, async_on in WINDOWS:
        label = "K=%d %s" % (K, "async" if async_on else "sync")
        toks, r = _megabatch_run(torch, tpa, ServingEngine, params, cfg,
                                 reqs, arrive, dev, decode_window=K,
                                 async_dispatch=async_on)
        base = toks if base is None else base
        if toks != base:
            bad = next(i for i, (a, b) in enumerate(zip(toks, base))
                       if a != b)
            raise AssertionError("%s: request %d diverged from K=1 sync: "
                                 "%s vs %s" % (label, bad, toks[bad][:16],
                                               base[bad][:16]))
        _check_window_launches(cfg, K, r, label, dev)
        if async_on and dev == "cuda":
            check(r["steady_chained_dispatches"] > 0,
                  "%s ran no steady chained dispatch" % label)
        out[label] = r
        log("  %-11s %d tokens in %.3f s = %.1f tokens/s; steps/token "
            "%.4f; band uploads %d; host share outside dispatch-to-sync "
            "%.4f; launches %s; steady chained dispatches under sync "
            "debug %d" % (label, r["tokens"], r["wall_s"],
                          r["tokens_per_s"], r["steps_per_token"],
                          r["band_uploads"],
                          r["host_share_outside_dispatch_sync"],
                          r["launches"], r["steady_chained_dispatches"]))
    qreqs, qarrive = reqs[:quant_n], arrive[:quant_n]
    for kvq in ("int8", "fp8"):
        got = {}
        for K, async_on in ((1, False), (8, True)):
            label = "%s K=%d %s" % (kvq, K, "async" if async_on else "sync")
            got[K], r = _megabatch_run(
                torch, tpa, ServingEngine, params, cfg, qreqs, qarrive, dev,
                decode_window=K, async_dispatch=async_on, kv_quant=kvq)
            _check_window_launches(cfg, K, r, label, dev)
            out[label] = r
            log("  %-17s %d tokens, %.1f tokens/s, launches %s"
                % (label, r["tokens"], r["tokens_per_s"], r["launches"]))
        check(got[8] == got[1], "%s: K=8 async tokens differ from K=1 sync"
              % kvq)
    return out


def adapter_registry(cfg, names=("ad_a", "ad_b", "ad_c"), rank=8):
    from paddle_tpu_torch.serving import AdapterRegistry, make_adapter

    reg = AdapterRegistry()
    for i, name in enumerate(names):
        reg.register(name, make_adapter(cfg, rank=rank, seed=i + 1))
    return reg


def phase_adapters(torch, T, tpa, ServingEngine, params, cfg, dev="cuda",
                   n=None):
    """Phase 14: phase 3's trace with every request but each fourth on
    one of 3 adapters through a 2-payload-slot pool (adapter_slots=3,
    bench.py:2882). The zero-adapter requests emit the tokens of an
    engine without a registry; the batched adapter requests emit what
    they emit served one at a time; decode and prefill launches of the
    batched run = layers x steps."""
    reqs = trace(cfg)[:n]
    names = (None, "ad_a", "ad_b", "ad_c")
    reg = adapter_registry(cfg)
    kw = dict(ENGINE, adapter_registry=reg, adapter_slots=3)

    def serve(eng, rs):
        hs = [eng.submit(**r) for r in rs[:-1]]
        eng.run()
        hs.append(eng.submit(**rs[-1]))  # after the first copy published
        eng.run()
        return [list(h.tokens) for h in hs]

    plain = serve(ServingEngine(params, cfg, device=dev, **ENGINE), reqs)
    with_ad = [dict(r, adapter=names[i % 4]) for i, r in enumerate(reqs)]
    eng = ServingEngine(params, cfg, device=dev, **kw)
    _sync(torch, dev)
    zero_launches(tpa)
    t0 = time.monotonic()
    batched = serve(eng, with_ad)
    _sync(torch, dev)
    wall = time.monotonic() - t0
    launches = read_launches(tpa)
    rep = eng.metrics.report()
    want = {"decode": cfg.layers * rep["decode_steps"],
            "prefill": cfg.layers * rep["prefill_chunks"], "verify": 0}
    if dev == "cuda":
        check(launches == want, "adapter launches %s != %s"
              % (launches, want))
    zero = [i for i, r in enumerate(with_ad) if r["adapter"] is None]
    check(all(batched[i] == plain[i] for i in zero),
          "a zero-adapter request differs from the engine without a "
          "registry")
    seq = ServingEngine(params, cfg, device=dev, **kw)
    for i, r in enumerate(with_ad):
        if r["adapter"] is None:
            continue
        h = seq.submit(**r)
        seq.run()
        check(list(h.tokens) == batched[i],
              "adapter request %d (%s): batched tokens differ from its "
              "sequential run" % (i, r["adapter"]))
    moved = sum(batched[i] != plain[i] for i in range(len(reqs))
                if i not in zero)
    check(moved > 0, "no adapter changed any request's tokens")
    pool = rep["adapter_pool"]
    check(pool["evictions"] >= 1, "3 adapters through 2 payload slots "
          "never evicted")
    toks = rep["tokens_out"]
    log("  %d requests (%d zero-adapter == no registry; %d adapter "
        "requests == sequential, %d of them moved by their adapter); %d "
        "tokens in %.3f s = %.1f tokens/s; pool %s; launches %s"
        % (len(reqs), len(zero), len(reqs) - len(zero), moved, toks, wall,
           toks / wall, pool, launches))
    return dict(launches=launches, tokens=toks, wall_s=wall,
                tokens_per_s=toks / wall, adapter_pool=pool)


def phase_integrity_store(torch, T, ServingEngine, params, cfg, dev="cuda",
                          n=None):
    """Phase 15: phase 3's trace with kv_fingerprints=True trips nothing
    and emits phase 3's tokens; the flip@ drill trips exactly once, at
    the aliased re-open; a durable store in a temp dir: engine A spills,
    engine B imports a handoff with zero closed-block tokens re-prefilled
    and A's tokens, and a warm start (the store reopened from disk) gives
    the same tokens without re-prefilling the header."""
    import tempfile

    from paddle_tpu_torch.distributed.fault_injection import FaultInjector
    from paddle_tpu_torch.serving import IntegrityError, KVBlockStore

    reqs = trace(cfg)[:n]

    def serve(eng, rs):
        hs = [eng.submit(**r) for r in rs[:-1]]
        eng.run()
        hs.append(eng.submit(**rs[-1]))
        eng.run()
        return [list(h.tokens) for h in hs]

    plain = serve(ServingEngine(params, cfg, device=dev, **ENGINE), reqs)
    fp = ServingEngine(params, cfg, device=dev, kv_fingerprints=True,
                       **ENGINE)
    check(serve(fp, reqs) == plain, "kv_fingerprints changed tokens")
    st = fp.metrics.report()["block_fingerprints"]
    check(st["mismatches"] == 0 and st["verified"] > 0
          and st["committed"] > 0, "clean fingerprint run: %s" % st)
    log("  fingerprints, clean: %s" % st)

    header = next(r for r in reqs if len(r["prompt"]) >= 160)
    inj = FaultInjector("")
    drill = ServingEngine(params, cfg, device=dev, kv_fingerprints=True,
                          fault_injector=inj, **ENGINE)
    drill.submit(**header).result()
    inj.arm("flip@1")
    tripped = None
    try:
        drill.submit(**header).result()
    except IntegrityError as exc:
        tripped = exc
    check(tripped is not None and tripped.kind == "fingerprint"
          and drill._fp.mismatches == 1,
          "the flip@ drill did not trip exactly once at the re-open: %r"
          % (tripped,))
    log("  flip@ drill: one %s trip (%s)" % (tripped.kind, tripped))

    Bt = ENGINE["kv_block_tokens"]
    with tempfile.TemporaryDirectory() as d:
        kw = dict(ENGINE, kv_fingerprints=True)
        store = KVBlockStore(dir=d, block_tokens=Bt)
        a = ServingEngine(params, cfg, device=dev, kv_store=store, **kw)
        ha = a.submit(**header)
        a.run()
        package = store.chain_fetch(header["prompt"])
        check(len(package) == 128 // Bt and
              a.metrics.store_spilled_blocks == len(package),
              "engine A spilled %d blocks, the store has %d of them"
              % (a.metrics.store_spilled_blocks, len(package)))
        b = ServingEngine(params, cfg, device=dev, kv_store=store, **kw)
        hb = b.submit(handoff=package, **header)
        b.run()
        mb = b.metrics
        check(mb.tokens_recomputed_at_migration == 0
              and mb.handoff_imports == 1 and mb.handoff_fallbacks == 0
              and hb.handoff_outcome == {"imported": 128,
                                         "fallback": False},
              "handoff: %s" % hb.handoff_outcome)
        check(hb.tokens == ha.tokens, "handoff tokens differ from A's")
        store.close()
        warm_store = KVBlockStore(dir=d, block_tokens=Bt)
        c = ServingEngine(params, cfg, device=dev, kv_store=warm_store,
                          kv_store_warm=True, **kw)
        warmed = c.metrics.store_warm_blocks
        hc = c.submit(**header)
        c.run()
        T0 = len(header["prompt"])
        check(warmed == len(package) and hc.tokens == ha.tokens
              and c.metrics.prefill_tokens_computed == T0 - 128,
              "warm start: %d blocks warmed, %d prefill tokens for a "
              "%d-token prompt" % (warmed, c.metrics.prefill_tokens_computed,
                                   T0))
        warm_store.close()
    out = dict(fingerprints=st, handoff_blocks=mb.handoff_blocks_imported,
               handoff_prefill_tokens=mb.prefill_tokens_computed,
               warm_blocks=warmed,
               warm_prefill_tokens=c.metrics.prefill_tokens_computed,
               prompt_tokens=T0)
    log("  store: A spilled %d blocks; B imported %d (0 recomputed), "
        "prefilled %d of %d prompt tokens; warm start %d blocks, %d "
        "prefill tokens; tokens equal" % (
            len(package), mb.handoff_blocks_imported,
            mb.prefill_tokens_computed, T0, warmed,
            c.metrics.prefill_tokens_computed))
    return out


# ---------------------------------------------------------------------
# phases 5-7: the flash-attention kernels and the training step
# ---------------------------------------------------------------------


def flash_case(rng, torch, dtype, B, T, S, H, D, dev="cuda"):
    def mk(n):
        a = rng.randn(B, n, H, D).astype(np.float32)
        return torch.from_numpy(a).to(dev, dtype)

    return dict(q=mk(T), k=mk(S), v=mk(S), g=mk(T))


def flash_inputs(torch, tfa, c, causal):
    """The f32 plain forward's (o, lse) and delta = rowsum(g * o) for a
    case: the backward kernels and their plain versions both take these
    same lse and delta."""
    q, k, v = (c[n].float() for n in "qkv")
    scale = c["q"].shape[-1] ** -0.5
    o, lse = tfa.flash_attention_plain(q, k, v, scale, causal)
    delta = (c["g"].float() * o).sum(-1).permute(0, 2, 1).contiguous()
    return o, lse, delta


def run_flash(tfa, which, c, causal, lse=None, delta=None, plain=False):
    """One flash wrapper on a case (or its plain version on f32 copies
    of the same inputs)."""
    q, k, v, g = c["q"], c["k"], c["v"], c["g"]
    if plain:
        q, k, v, g = q.float(), k.float(), v.float(), g.float()
    scale = q.shape[-1] ** -0.5
    if which == "forward":
        fn = tfa.flash_attention_plain if plain else tfa.flash_forward
        return fn(q, k, v, scale, causal)
    if which == "backward_kv":
        fn = tfa.flash_backward_kv_plain if plain else tfa.flash_backward_kv
    else:
        fn = tfa.flash_backward_q_plain if plain else tfa.flash_backward_q
    return fn(q, k, v, g, lse, delta, scale, causal)


def _held(torch, got, want, f32):
    """f32: atol/rtol 1e-4 (reduction order only). bf16: rtol 2e-2 and
    atol 2e-2 x max|want| against the plain version in f32 on the same
    bf16 inputs — the kernel rounds P or dS to bf16 before each product
    and its output to bf16 (~3 significant digits each)."""
    got = got.float()
    err = float((got - want).abs().max())
    tol = 1e-4 if f32 else 2e-2
    atol = tol if f32 else tol * float(want.abs().max())
    ok = torch.allclose(got, want, atol=atol, rtol=tol) and bool(
        torch.isfinite(got).all())
    return err, ok


def check_flash(torch, tfa, c, causal, label):
    """Hold the three flash kernels against their plain versions on one
    case; returns {kernel: max abs error} (the forward's over o; its
    lse, f32 in both dtypes, is held at 1e-4 on its own)."""
    f32 = c["q"].dtype == torch.float32
    o, lse, delta = flash_inputs(torch, tfa, c, causal)
    got_o, got_lse = run_flash(tfa, "forward", c, causal)
    got_kv = run_flash(tfa, "backward_kv", c, causal, lse, delta)
    got_q = run_flash(tfa, "backward_q", c, causal, lse, delta)
    _sync(torch, c["q"].device.type)  # a kernel fault surfaces here
    want_kv = run_flash(tfa, "backward_kv", c, causal, lse, delta,
                        plain=True)
    want_q = run_flash(tfa, "backward_q", c, causal, lse, delta,
                       plain=True)
    errs, oks = {}, []
    for name, got, want in (("forward", got_o, o),
                            ("backward_kv", got_kv[0], want_kv[0]),
                            ("backward_kv", got_kv[1], want_kv[1]),
                            ("backward_q", got_q, want_q)):
        err, ok = _held(torch, got, want, f32)
        errs[name] = max(errs.get(name, 0.0), err)
        oks.append(ok)
    lse_err = float((got_lse - lse).abs().max())
    oks.append(torch.allclose(got_lse, lse, atol=1e-4, rtol=1e-4))
    log("  %-40s max_abs_err o %.3e lse %.3e dk/dv %.3e dq %.3e %s"
        % (label, errs["forward"], lse_err, errs["backward_kv"],
           errs["backward_q"], "ok" if all(oks) else "FAIL"))
    if not all(oks):
        raise AssertionError("flash kernel disagrees with its plain "
                             "version: " + label)
    return errs


def flash_bound_ms(which, B, T, S, H, D, esize, causal, dtype_name):
    """Least time for one flash kernel's work: every input read once and
    every output written once over the HBM rate, vs 2*D flops per
    attended (q, k) pair per matrix product at the peak rate."""
    pairs = B * H * (T * (T + 1) // 2 if causal else T * S)
    flops = 2 * D * pairs * FLASH_PRODUCTS[which]
    qs, ks, rows = B * T * H * D * esize, B * S * H * D * esize, B * H * T * 4
    nbytes = {"forward": 2 * qs + 2 * ks + rows,          # q k v -> o lse
              "backward_kv": 2 * qs + 4 * ks + 2 * rows,  # q g k v lse d -> dk dv
              "backward_q": 3 * qs + 2 * ks + 2 * rows,   # q g k v lse d -> dq
              }[which]
    t_bytes = nbytes / HBM_BPS * 1e3
    t_ops = flops / PEAK_FLOPS[dtype_name] * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops
            else "operations")


def sdpa_ms(torch, c, causal):
    """One PyTorch call computing the same function, timed as the
    yardstick (never called by the port): scaled_dot_product_attention
    forward, and its backward (dq, dk, dv together)."""
    import torch.nn.functional as F

    q, k, v, g = (c[n].transpose(1, 2).contiguous() for n in "qkvg")
    fwd = time_ms(torch, lambda: F.scaled_dot_product_attention(
        q, k, v, is_causal=causal))
    q, k, v = (t.requires_grad_(True) for t in (q, k, v))
    out = F.scaled_dot_product_attention(q, k, v, is_causal=causal)
    bwd = time_ms(torch, lambda: torch.autograd.grad(
        out, (q, k, v), g, retain_graph=True))
    return fwd, bwd


def ptxas_usage(text):
    """{mangled kernel name: registers, stack, spill_stores, spill_loads}
    from nvcc's -Xptxas -v output."""
    out, cur = {}, None
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            cur = out.setdefault(m.group(1), {})
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m:
            cur.update(stack=int(m[1]), spill_stores=int(m[2]),
                       spill_loads=int(m[3]))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            cur["registers"] = int(m[1])
    return out


def sass_tensor_ops(lib_path, nvcc):
    """{mangled kernel name: count of tensor-core instructions (HMMA,
    HGMMA)} in the library's SASS, by cuobjdump beside nvcc."""
    cuobjdump = os.path.join(os.path.dirname(nvcc), "cuobjdump")
    text = subprocess.run([cuobjdump, "-sass", lib_path],
                          capture_output=True, text=True, timeout=300,
                          check=True).stdout
    counts, cur = {}, None
    for line in text.splitlines():
        if "Function :" in line:
            cur = line.split("Function :", 1)[1].strip()
            counts[cur] = 0
        elif cur is not None and ("HMMA" in line or "HGMMA" in line):
            counts[cur] += 1
    return counts


def _kernel_label(mangled):
    """flash_forward_mma_kernel<bf16, 64> and the like, from a mangled
    name (None for anything else)."""
    m = re.search(r"(flash_[a-z_]+_kernel)I(13__nv_bfloat16|f)?Li(\d+)E",
                  mangled)
    if m is None:
        return None
    dtype = "f32" if m[2] == "f" else "bf16"
    return "%s<%s, %s>" % (m[1], dtype, m[3])


def flash_build_report(_build):
    """Phase 1's report of every flash kernel instantiation: registers,
    stack and spills (nvcc) and tensor-core instructions (SASS). Gate:
    each of the nine tensor-core kernels (three passes x D 32/64/128)
    holds HMMA/HGMMA and spills 0 bytes."""
    usage = ptxas_usage(_build.compiler_output("flash_attention"))
    lib = _build.build(["flash_attention"])["flash_attention"]
    ops = sass_tensor_ops(lib, _build._nvcc())
    report = {}
    for name, u in usage.items():
        label = _kernel_label(name)
        if label is None:
            continue
        u = dict(u, tensor_core_ops=ops.get(name, 0))
        report[label] = u
        log("  %-38s %3d registers, stack %d B, spills %d B stored / %d B "
            "loaded, %d tensor-core instructions (HMMA/HGMMA) in SASS"
            % (label, u.get("registers", -1), u.get("stack", -1),
               u.get("spill_stores", -1), u.get("spill_loads", -1),
               u["tensor_core_ops"]))
    mma = {k: u for k, u in report.items() if "_mma_kernel" in k}
    check(len(mma) == 9, "expected the bf16 forward, dK/dV and dQ "
          "tensor-core kernels at D 32, 64 and 128, found %s" % sorted(mma))
    for k, u in mma.items():
        check(u["tensor_core_ops"] > 0, "%s has no tensor-core instruction"
              % k)
        check(u.get("spill_stores") == 0 and u.get("spill_loads") == 0,
              "%s spills registers" % k)
    return report


_TYPE_CODES = (("13__nv_bfloat16", "bf16"), ("13__nv_fp8_e4m3", "e4m3"),
               ("f", "f32"), ("a", "int8"))


def _paged_label(mangled):
    """paged_split_kernel<bf16, 1, 2> and the like, from a mangled name
    (None for anything else)."""
    m = re.search(r"(paged_[a-z_]+_kernel)", mangled)
    if m is None:
        return None
    rest, args = mangled[m.end():], []
    if rest.startswith("I"):
        rest = rest[1:]
        while rest and not rest.startswith("E"):
            n = re.match(r"Li(\d+)E", rest)
            if n:
                args.append(n[1])
                rest = rest[n.end():]
                continue
            for code, name in _TYPE_CODES:
                if rest.startswith(code):
                    args.append(name)
                    rest = rest[len(code):]
                    break
            else:
                return None
    return m[1] + ("<%s>" % ", ".join(args) if args else "")


def paged_build_report(_build):
    """Phase 1's report of every paged kernel instantiation: registers,
    stack and spills (nvcc)."""
    report = {}
    for name, u in ptxas_usage(_build.compiler_output(
            "paged_attention")).items():
        label = _paged_label(name)
        if label is None:
            continue
        report[label] = u
        log("  %-38s %3d registers, stack %d B, spills %d B stored / %d B "
            "loaded" % (label, u.get("registers", -1), u.get("stack", -1),
                        u.get("spill_stores", -1), u.get("spill_loads", -1)))
    check(any(k.startswith("paged_split_kernel") for k in report)
          and "paged_merge_kernel" in report,
          "the split and merge kernels are missing from the build: %s"
          % sorted(report))
    return report


# the kernel instantiation each flash entry point launches for bf16 at
# the training shape's head width (64)
FLASH_TRAIN_KERNEL = {
    "forward": "flash_forward_mma_kernel<bf16, 64>",
    "backward_kv": "flash_backward_kv_mma_kernel<bf16, 64>",
    "backward_q": "flash_backward_q_mma_kernel<bf16, 64>",
}


def phase_flash(torch, tfa, build_report):
    """Phase 5: the three flash kernels vs their plain versions at the
    training shape (bf16 and f32, causal) and the JAX suite's odd shapes,
    then bf16 timings at the training shape."""
    rng = np.random.RandomState(5)
    B, T, H, D = TRAIN["batch"], TRAIN["seq"], FULL["heads"], \
        FULL["dim"] // FULL["heads"]
    errs = {}
    full = {}
    for dtype in (torch.bfloat16, torch.float32):
        name = str(dtype).split(".")[-1]
        full[name] = flash_case(rng, torch, dtype, B, T, T, H, D)
        errs[name] = check_flash(torch, tfa, full[name], True,
                                 "%s causal B%d T%d H%d D%d" % (name, B, T,
                                                                H, D))
    for dtype in (torch.bfloat16, torch.float32):
        name = str(dtype).split(".")[-1]
        # cross-attention T != S: dK/dV and dQ walk different extents
        check_flash(torch, tfa, flash_case(rng, torch, dtype, 2, 128, 384,
                                           2, 32), False,
                    "%s cross T128 S384 D32" % name)
        for t in (100, 768):  # ragged last tiles
            check_flash(torch, tfa, flash_case(rng, torch, dtype, 2, t, t,
                                               4, 64), True,
                        "%s causal T%d D64" % (name, t))
        # the tensor-core tiles' edges: D padded to its 64 or filling the
        # 128 bucket, one row past a 128-row tile, a ragged 64-row step in
        # q and in k, and a single (b, h) slice
        for (nb, t, s, h, d, causal) in ((2, 256, 256, 2, 40, True),
                                         (2, 256, 256, 2, 128, True),
                                         (2, 129, 129, 2, 64, True),
                                         (2, 200, 72, 2, 64, False),
                                         (1, 384, 384, 1, 64, True)):
            check_flash(torch, tfa, flash_case(rng, torch, dtype, nb, t, s,
                                               h, d), causal,
                        "%s %s B%d T%d S%d H%d D%d" % (
                            name, "causal" if causal else "cross", nb, t, s,
                            h, d))
    del full["float32"]
    c = full["bfloat16"]
    o, lse, delta = flash_inputs(torch, tfa, c, True)
    # each output tile has one owner and no atomics: launches repeat
    for which in ("forward", "backward_kv", "backward_q"):
        first = run_flash(tfa, which, c, True, lse, delta)
        again = run_flash(tfa, which, c, True, lse, delta)
        if which == "backward_q":
            first, again = (first,), (again,)
        same = all(torch.equal(x, y) for x, y in zip(first, again))
        log("  %-11s bf16 twice on the training shape: bit-identical %s"
            % (which, same))
        check(same, "%s kernel is not deterministic" % which)
    lib_fwd, lib_bwd = sdpa_ms(torch, c, True)
    timing = {}
    for which in ("forward", "backward_kv", "backward_q"):
        ms = time_ms(torch, lambda: run_flash(tfa, which, c, True, lse,
                                              delta))
        plain = time_ms(torch, lambda: run_flash(
            tfa, which, c, True, lse, delta, plain=True), iters=10)
        b, by = flash_bound_ms(which, B, T, T, H, D, 2, True, "bfloat16")
        lib = lib_fwd if which == "forward" else lib_bwd
        kern = FLASH_TRAIN_KERNEL[which]
        res = dict(build_report[kern])
        res["shared_bytes"] = tfa.shared_bytes(which, torch.bfloat16, D)
        timing[which] = dict(ms=ms, plain_ms=plain, bound_ms=b, bound_by=by,
                             library_ms=lib, kernel=kern, resources=res)
        log("  %-11s bf16: kernel %.4f ms, plain %.4f ms, bound %.4f ms "
            "(%s), SDPA %s %.4f ms; %s: %s registers, %d B shared, "
            "spills %s B / %s B, %s tensor-core instructions"
            % (which, ms, plain, b, by, "forward" if which == "forward"
               else "backward (dq, dk, dv)", lib, kern,
               res.get("registers"), res["shared_bytes"],
               res.get("spill_stores"), res.get("spill_loads"),
               res.get("tensor_core_ops")))
    return errs, timing


def _train_flops(B, T):
    """bench.py:953-955's count for one forward (matmul parameters, the
    tied head once, causal attention); a train step is 3x."""
    L, d, V = FULL["layers"], FULL["dim"], FULL["vocab"]
    p_mat = V * d + L * 12 * d * d
    return 2.0 * B * T * p_mat + L * B * 2.0 * T * T * d


def train_tokens(vocab, seed=0):
    rng = np.random.RandomState(seed)
    return rng.randint(0, vocab, (TRAIN["batch"], TRAIN["seq"] + 1))


def phase_train(torch, T, tfa, steps=10, warm=2, dev="cuda", full=FULL):
    """Phase 6: the training configuration in bf16 through
    make_train_step(attn_impl="flash"): warm-up steps, then `steps`
    timed steps on one fixed batch with the flash counters zeroed just
    before and read just after."""
    cfg = T.TransformerConfig(dtype=torch.bfloat16, **full)
    gen = torch.Generator(device=dev).manual_seed(1)
    params = T.init_params(cfg, gen, device=dev)
    toks = torch.from_numpy(train_tokens(cfg.vocab)).to(dev)
    step = T.make_train_step(cfg, lr=TRAIN["lr"], attn_impl="flash")
    for _ in range(warm):
        step(params, toks)
    _sync(torch, dev)
    for key in tfa.launches:
        tfa.launches[key] = 0
    t0 = time.monotonic()
    losses = [step(params, toks)[1] for _ in range(steps)]
    _sync(torch, dev)
    wall = time.monotonic() - t0
    launches = dict(tfa.launches)
    losses = [float(x) for x in losses]
    check(all(math.isfinite(x) for x in losses), "a training loss is not "
          "finite: %s" % losses)
    want = cfg.layers * steps
    log("  launches: %s (layers x steps = %d)" % (launches, want))
    if dev == "cuda":
        check(all(n == want for n in launches.values()),
              "flash kernel launches != layers x steps")
    B, Tn = toks.shape[0], toks.shape[1] - 1
    dt = wall / steps
    flop_share = 3.0 * _train_flops(B, Tn) / dt / PEAK_FLOPS["bfloat16"]
    log("  losses %s" % ", ".join("%.4f" % x for x in losses))
    log("  %d steps of [%d, %d] tokens: %.3f ms/step, %.1f tokens/s, "
        "FLOP share %.4f of 989 TFLOP/s (bench.py's count)"
        % (steps, B, Tn + 1, dt * 1e3, B * Tn / dt, flop_share))
    return launches, dict(ms_per_step=dt * 1e3, tokens_per_s=B * Tn / dt,
                          flop_share=flop_share, losses=losses), \
        (step, params, toks)


def phase_train_parity(torch, T, steps=3, lr=1e-2, dev="cuda", full=FULL):
    """Phase 7: the same f32 weights and batch through 3 SGD steps of
    attn_impl="flash" (the kernels) and attn_impl="reference" (plain
    torch autograd). Losses agree within rtol 1e-4 and every final
    parameter within atol/rtol 1e-4: f32 reduction order through 8
    layers and 3 steps, the two paths scaling the scores at different
    points (after QK^T vs folded into q)."""
    cfg = T.TransformerConfig(dtype=torch.float32, **full)
    gen = torch.Generator(device=dev).manual_seed(2)
    base = T.init_params(cfg, gen, device=dev)
    toks = torch.from_numpy(train_tokens(cfg.vocab, seed=1)).to(dev)
    runs = {}
    for impl in ("flash", "reference"):
        params = _tree_map(lambda t: t.detach().clone(), base)
        step = T.make_train_step(cfg, lr=lr, attn_impl=impl)
        losses = [float(step(params, toks)[1]) for _ in range(steps)]
        runs[impl] = (losses, params)
    (la, pa), (lb, pb) = runs["flash"], runs["reference"]
    loss_err = max(abs(a - b) / abs(b) for a, b in zip(la, lb))
    leaves = list(zip(T._leaves(pa), T._leaves(pb), T._leaves(base)))
    with torch.no_grad():
        p_err = max(float((a - b).abs().max()) for a, b, _ in leaves)
        moved = max(float((a - p0).abs().max()) for a, _, p0 in leaves)
        ok = loss_err <= 1e-4 and all(
            torch.allclose(a, b, atol=1e-4, rtol=1e-4) for a, b, _ in leaves)
    log("  f32 %d steps lr %g: losses flash %s vs reference %s; max rel "
        "loss diff %.3e, max param diff %.3e (params moved up to %.3e) %s"
        % (steps, lr, ["%.6f" % x for x in la], ["%.6f" % x for x in lb],
           loss_err, p_err, moved, "ok" if ok else "FAIL"))
    check(ok, "f32 flash training diverged from the reference path")
    return dict(loss_rel_err=loss_err, param_abs_err=p_err)


def _device_us(evt):
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, name):
            return getattr(evt, name)
    return 0.0


def _kernel_class(name):
    if any(k in name for k in ("paged_attention", "paged_split",
                               "paged_merge")):
        return "paged attention kernels"
    for kernel in ("flash_forward", "flash_backward_kv", "flash_backward_q"):
        if kernel in name:
            return kernel + " kernel"
    if any(k in name for k in ("nvjet", "gemm", "cutlass", "sm90_xmma")):
        return "GEMM (cuBLAS)"
    if "Memcpy" in name or "Memset" in name:
        return "memcpy/memset"
    return "elementwise, reduce, index"


def _profile_window(torch, run, n, label):
    """torch.profiler over `run()` called n times: wall ms per call, the
    device-busy share (summed device-side kernel, copy and memset time
    over wall; one stream, so they do not overlap), device ms per call
    by kernel class, and the kernels that take the most device time.
    The profiler's own host cost inflates the wall."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        for _ in range(n):
            run()
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
    evts = [e for e in prof.key_averages()
            if getattr(e, "device_type", None) == DeviceType.CUDA
            and _device_us(e) > 0]
    busy = sum(_device_us(e) for e in evts) / 1e6
    classes = {}
    for e in evts:
        c = _kernel_class(e.key)
        classes[c] = classes.get(c, 0.0) + _device_us(e) / 1e3 / n
    log("  profile %s: %.3f ms/step wall (profiled), device busy "
        "%.4f ms/step = %.4f of wall, %d device ops"
        % (label, wall / n * 1e3, busy / n * 1e3, busy / wall,
           sum(e.count for e in evts)))
    for c, ms in sorted(classes.items(), key=lambda kv: -kv[1]):
        log("    class %-28s %.4f ms/step device" % (c, ms))
    for e in sorted(evts, key=_device_us, reverse=True)[:6]:
        log("    %-60s %6d calls %9.3f ms device"
            % (e.key[:60], e.count, _device_us(e) / 1e3))


def phase_profile(torch, ServingEngine, params, cfg, windows=(6, 24)):
    """torch.profiler over the serving trace: the first steps (admission
    and prefill chunks beside decode) and then steady decode steps. The
    unprofiled step time is phase 3's."""
    eng = ServingEngine(params, cfg, device="cuda", **ENGINE)
    for r in trace(cfg)[:-1]:
        eng.submit(**r)
    for label, n in zip(("first %d steps" % windows[0],
                         "next %d steps" % windows[1]), windows):
        _profile_window(torch, eng.step, n, label)
    eng.run()


def phase_profile_quant(torch, ServingEngine, params, cfg, warm=8, n=24):
    """torch.profiler over `n` decode-dominated steps of the serving_quant
    configuration for kv_quant none and int8, at the same 12 requests of
    the trace submitted at once and a pool that holds them all, after
    `warm` unprofiled steps."""
    reqs, _ = poisson_trace(cfg.vocab)
    for kvq in ("none", "int8"):
        eng = ServingEngine(params, cfg, device="cuda", kv_quant=kvq,
                            **QUANT_ENGINE)
        for prompt, m in reqs[:12]:
            eng.submit(prompt, m, publish_len=POISSON["header"])
        for _ in range(warm):
            eng.step()
        _profile_window(torch, eng.step, n, "kv_quant %s, %d steps"
                        % (kvq, n))
        eng.run()


def phase_profile_windows(torch, ServingEngine, params, cfg, warm=4, n=12):
    """torch.profiler over `n` steps of the megabatch configuration's
    first 16 requests, submitted at once, for K=1 sync and K=8 async,
    after `warm` unprofiled steps: device busy per step and per token."""
    reqs, _ = megabatch_trace(cfg.vocab)
    for K, async_on in ((1, False), (8, True)):
        eng = ServingEngine(params, cfg, max_slots=MEGABATCH["slots"],
                            device="cuda", decode_window=K,
                            async_dispatch=async_on)
        for i, (p, m, temp) in enumerate(reqs[:16]):
            eng.submit(p, m, temperature=temp, seed=1000 + i)
        for _ in range(warm):
            eng.step()
        _profile_window(torch, eng.step, n, "K=%d %s, %d steps of %d "
                        "tokens" % (K, "async" if async_on else "sync", n,
                                    K))
        eng.run()


# ---------------------------------------------------------------------
# phases 16-18: the Fluid Program/Executor (paddle_tpu_torch.fluid)
# ---------------------------------------------------------------------

# the headline (bench.py:211-229, :515-535): ResNet-50, batch 128, bf16 AMP
FLUID_RESNET = dict(batch=128, shape=[3, 224, 224], classes=1000, depth=50)
RESNET50_FWD_FLOPS = 4.09e9  # bench.py:199, per 224x224 image
FLUID_PARITY = dict(batch=16, shape=[3, 32, 32], classes=10, depth=8)
FLUID_FLASH = dict(batch=8, seq=1024, heads=8, dim=64)


def fluid_image_program(fluid, model, shape, classes, amp):
    """bench.py's _build_image_workload with float32 images and int64
    labels: model -> cross_entropy -> mean, Momentum(0.01, 0.9)."""
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        image = fluid.layers.data(name="image", shape=shape, dtype="float32")
        label = fluid.layers.data(name="label", shape=[1], dtype="int64")
        predict = model(image, classes)
        avg = fluid.layers.mean(
            x=fluid.layers.cross_entropy(input=predict, label=label))
        fluid.optimizer.Momentum(learning_rate=0.01, momentum=0.9).minimize(
            avg)
    main.amp = amp
    return main, startup, avg


def image_feed(torch, batch, shape, classes, dev):
    """bench.py:525-529's fixed synthetic batch, on `dev`."""
    rng = np.random.RandomState(0)
    image = rng.rand(batch, *shape).astype(np.float32)
    label = rng.randint(0, classes, (batch, 1)).astype(np.int64)
    return {"image": torch.from_numpy(image).to(dev),
            "label": torch.from_numpy(label).to(dev)}


def _fluid_class(name):
    if any(k in name for k in ("implicit_gemm", "fprop", "dgrad", "wgrad",
                               "conv", "cudnn", "nchwToNhwc", "nhwcToNchw",
                               "winograd")):
        return "convolution (cuDNN)"
    if any(k in name for k in ("nvjet", "gemm", "cutlass")):
        return "GEMM (cuBLAS)"
    if "Memcpy" in name or "Memset" in name:
        return "memcpy/memset"
    if any(k in name for k in ("index", "gather", "scatter", "embedding")):
        return "index and gather"
    return "batch norm, elementwise, reduce"


FLUID_REGIONS = ("fluid/forward", "fluid/optimizer")


def profile_fluid(torch, run, n, label, extra_regions=()):
    """torch.profiler over `run()` n times: wall, device-busy share and
    device ops per step; device ms per step by kernel class; and the
    forward and optimizer regions (the lowering's record_function ranges)
    as the sum of their kernels' device time; autograd's engine thread
    launches the backward's kernels, so the backward is the rest of the
    busy time. The optimizer's
    kernels are elementwise: the elementwise class includes them.
    `extra_regions` names more ranges (inside the forward region, as
    profiler.OpCounter's per-op ones) whose device time to report
    alone."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        for _ in range(n):
            run()
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
    avgs = prof.key_averages()
    kernels = [e for e in avgs
               if getattr(e, "device_type", None) == DeviceType.CUDA
               and _device_us(e) > 0 and e.key not in FLUID_REGIONS
               and e.key not in extra_regions]
    busy = sum(_device_us(e) for e in kernels) / 1e6
    classes = {}
    for e in kernels:
        c = _fluid_class(e.key)
        classes[c] = classes.get(c, 0.0) + _device_us(e) / 1e3 / n
    regions, extra = {}, {}
    for e in avgs:
        if e.key in FLUID_REGIONS + tuple(extra_regions) and getattr(
                e, "device_type", None) == DeviceType.CPU:
            total = getattr(e, "device_time_total",
                            getattr(e, "cuda_time_total", 0.0))
            (regions if e.key in FLUID_REGIONS else extra)[e.key] = \
                total / 1e3 / n
    ops = sum(e.count for e in kernels) / n
    log("  profile %s: %.3f ms/step wall (profiled), device busy %.4f "
        "ms/step = %.4f of wall, %.0f device ops/step"
        % (label, wall / n * 1e3, busy / n * 1e3, busy / wall, ops))
    for c, ms in sorted(classes.items(), key=lambda kv: -kv[1]):
        log("    class %-34s %.4f ms/step device" % (c, ms))
    if len(regions) == len(FLUID_REGIONS):
        regions["fluid/backward"] = busy / n * 1e3 - sum(regions.values())
    for r in ("fluid/forward", "fluid/backward", "fluid/optimizer"):
        log("    region %-33s %s" % (r, "%.4f ms/step device (kernels)"
                                    % regions[r] if r in regions
                                    else "not measured"))
    for r in extra_regions:
        log("    range %-34s %s" % (r, "%.4f ms/step device (forward "
                                   "kernels), %.4f of busy" % (
                                       extra[r], extra[r] / (busy / n * 1e3))
                                   if r in extra and busy else
                                   "not measured"))
    for e in sorted(kernels, key=_device_us, reverse=True)[:8]:
        log("    %-60s %6d calls %9.3f ms device"
            % (e.key[:60], e.count, _device_us(e) / 1e3))
    return dict(wall_ms=wall / n * 1e3, busy_ms=busy / n * 1e3,
                busy_share=busy / wall, ops_per_step=ops, classes=classes,
                regions=dict(regions, **extra))


def phase_fluid_resnet(torch, fluid, resnet, profile=False, warm=2,
                       steps=10, place=None, cfg=FLUID_RESNET, amp=True):
    """Phase 16: the headline ResNet-50 configuration trained through the
    port's Fluid Executor on the card (`place` and `cfg` shrink it for a
    rehearsal on the CPU; phase 40 runs it in f32, `amp=False`)."""
    main, startup, avg = fluid_image_program(
        fluid, lambda x, c: resnet.resnet_imagenet(x, c, depth=cfg["depth"]),
        cfg["shape"], cfg["classes"], amp=amp)
    scope = fluid.Scope()
    torch.backends.cudnn.benchmark = True
    try:
        with fluid.scope_guard(scope):
            exe = fluid.Executor(place or fluid.CUDAPlace(0))
            dev = exe.device
            t0 = time.monotonic()
            exe.run(startup)
            _sync(torch, dev.type)
            startup_s = time.monotonic() - t0
            n_params = sum(scope.get(p.name).numel() for p in
                           main.global_block().all_parameters())
            feed = image_feed(torch, cfg["batch"], cfg["shape"],
                              cfg["classes"], dev)

            def step():
                return exe.run(main, feed=feed, fetch_list=[avg],
                               return_numpy=False)[0]

            t0 = time.monotonic()
            losses = [step() for _ in range(warm)]
            _sync(torch, dev.type)
            warm_s = time.monotonic() - t0
            if dev.type == "cuda":
                torch.cuda.reset_peak_memory_stats()
            t0 = time.monotonic()
            losses += [step() for _ in range(steps)]
            _sync(torch, dev.type)
            wall = time.monotonic() - t0
            peak = (torch.cuda.max_memory_allocated() if dev.type == "cuda"
                    else 0)
            losses = [float(x.reshape(())) for x in losses]
            check(all(math.isfinite(x) for x in losses),
                  "a Fluid ResNet-50 loss is not finite: %s" % losses)
            check(losses[-1] < losses[0], "the Fluid ResNet-50 loss did not "
                  "fall on a fixed batch: %s" % losses)
            ips = cfg["batch"] * steps / wall
            peak_flops = PEAK_FLOPS["bfloat16" if amp else "float32"]
            share = ips * 3 * RESNET50_FWD_FLOPS / peak_flops
            log("  %d parameters; startup %.1f s, %d warm-up steps %.1f s "
                "(cudnn.benchmark on)" % (n_params, startup_s, warm, warm_s))
            log("  losses %s" % ", ".join("%.4f" % x for x in losses))
            log("  %d steps of batch %d: %.3f ms/step, %.1f img/s, peak "
                "device memory %.2f GiB, FLOP share %.4f of %.0f TFLOP/s "
                "(bench.py's count)" % (steps, cfg["batch"], wall / steps
                                        * 1e3, ips, peak / 2 ** 30, share,
                                        peak_flops / 1e12))
            out = dict(img_per_s=ips, ms_per_step=wall / steps * 1e3,
                       peak_mem_gib=peak / 2 ** 30, flop_share=share,
                       losses=losses, startup_s=startup_s, warm_s=warm_s)
            if profile:
                out["profile"] = profile_fluid(torch, step, 3,
                                               "3 Fluid ResNet-50 steps")
    finally:
        torch.backends.cudnn.benchmark = False
    del scope, exe, feed, step
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
    return out


def phase_fluid_parity(torch, fluid, resnet, steps=3, place=None):
    """Phase 17: resnet_cifar10(depth=8) in f32 from one set of startup
    weights, 3 Momentum steps on the card (TF32 off, as main() sets) and
    on the CPU. Losses within rtol 1e-4; parameters and batch-norm
    running statistics within atol 1e-4 (the velocities, raw gradient
    sums, are reported: the batch-norm variance E[x^2] - E[x]^2 amplifies
    their reduction-order error)."""
    cfg = FLUID_PARITY
    main, startup, avg = fluid_image_program(
        fluid, lambda x, c: resnet.resnet_cifar10(x, c, depth=cfg["depth"]),
        cfg["shape"], cfg["classes"], amp=False)
    init = fluid.Scope()
    with fluid.scope_guard(init):
        fluid.Executor(fluid.CPUPlace()).run(startup)
    init = fluid.scope_to_numpy(init)
    runs = {}
    for side, where in (("card", place or fluid.CUDAPlace(0)),
                        ("cpu", fluid.CPUPlace())):
        exe = fluid.Executor(where)
        scope = fluid.scope_from_numpy(fluid.Scope(), init, exe.device)
        feed = image_feed(torch, cfg["batch"], cfg["shape"], cfg["classes"],
                          exe.device)
        with fluid.scope_guard(scope):
            losses = [float(exe.run(main, feed=feed,
                                    fetch_list=[avg])[0][0])
                      for _ in range(steps)]
        runs[side] = (losses, fluid.scope_to_numpy(scope))
    (lc, sc), (lh, sh) = runs["card"], runs["cpu"]
    block = main.global_block()
    model = {p.name for p in block.all_parameters()}
    for op in block.ops:
        if op.type == "batch_norm":
            model |= set(op.input("Mean") + op.input("Variance"))
    loss_err = max(abs(a - b) / abs(b) for a, b in zip(lc, lh))
    diff = {n: float(np.abs(sc[n] - sh[n]).max()) for n in sh}
    p_err = max(diff[n] for n in model)
    v_err = max(d for n, d in diff.items() if n not in model)
    moved = max(float(np.abs(sh[n] - init[n]).max()) for n in model)
    ok = loss_err <= 1e-4 and p_err <= 1e-4
    log("  f32 %d steps: losses card %s vs CPU %s; max rel loss diff %.3e, "
        "max param/statistic diff %.3e (moved up to %.3e), max optimizer "
        "state diff %.3e %s" % (steps, ["%.6f" % x for x in lc],
                                ["%.6f" % x for x in lh], loss_err, p_err,
                                moved, v_err, "ok" if ok else "FAIL"))
    check(ok, "Fluid f32 training on the card diverged from the CPU")
    return dict(loss_rel_err=loss_err, param_abs_err=p_err,
                optimizer_state_abs_err=v_err)


def phase_fluid_flash(torch, fluid, tfa, place=None, cfg=FLUID_FLASH,
                      mesh=None):
    """Phase 18: a Fluid program whose flash_attention op reaches the
    Hopper kernels, forward and backward, through one bf16 SGD step of
    the Executor (on the CPU, a rehearsal: the plain versions run and no
    kernel launches; phase 38 runs it on `mesh`)."""
    B, T, H, D = cfg["batch"], cfg["seq"], cfg["heads"], cfg["dim"]
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        q, k, v = (fluid.layers.data(name=n, shape=[T, H, D],
                                     dtype="float32") for n in "qkv")
        qp = fluid.layers.fc(input=q, size=D, num_flatten_dims=3,
                             bias_attr=False)
        out = fluid.layers.flash_attention(qp, k, v, causal=True)
        loss = fluid.layers.mean(x=out)
        fluid.optimizer.SGD(learning_rate=0.1).minimize(loss)
    main.amp = True
    w = main.global_block().all_parameters()[0].name
    scope = fluid.Scope()
    with fluid.scope_guard(scope):
        exe = fluid.Executor(mesh=mesh) if mesh is not None else \
            fluid.Executor(place or fluid.CUDAPlace(0))
        rng = np.random.RandomState(18)
        feed = {n: torch.from_numpy(rng.randn(B, T, H, D).astype(
            np.float32)).to(exe.device) for n in "qkv"}
        exe.run(startup)
        _sync(torch, exe.device.type)
        for key in tfa.launches:
            tfa.launches[key] = 0
        got = exe.run(main, feed=feed, fetch_list=[out, qp, "k", "v", loss,
                                                   w + "@GRAD"],
                      return_numpy=False)
        _sync(torch, exe.device.type)
        launches = dict(tfa.launches)
    o, qb, kb, vb, lval, grad = got
    check(o.dtype == torch.bfloat16 and qb.dtype == torch.bfloat16,
          "the Fluid flash op did not run in bf16: %s %s" % (o.dtype,
                                                             qb.dtype))
    want, _ = tfa.flash_attention_plain(qb.float(), kb.float(), vb.float(),
                                        D ** -0.5, True)
    err, ok = _held(torch, o, want, f32=False)
    finite = bool(torch.isfinite(lval).all()) and bool(
        torch.isfinite(grad).all())
    log("  launches %s (each must be 1); output vs plain max_abs_err %.3e "
        "%s; loss %.6f, |grad| max %.3e" % (
            launches, err, "ok" if ok else "FAIL", float(lval.reshape(())),
            float(grad.abs().max())))
    if exe.device.type == "cuda":
        check(all(launches[kn] == 1 for kn in ("forward", "backward_kv",
                                               "backward_q")),
              "the Fluid flash op's step did not launch each kernel once: "
              "%s" % launches)
    check(ok and finite, "the Fluid flash op disagrees with the plain "
          "version or is not finite")
    return dict(launches=launches, max_abs_err=err)


# ---------------------------------------------------------------------
# phases 20-22: LoD sequences and dynamic RNNs through the Fluid port
# ---------------------------------------------------------------------

# bench.py:800-850 (bench_lstm, the benchmark/paddle/rnn LSTM): batch 64
# x 100 tokens, vocab 30000, embedding 128, 2 x (fc to 4*512, then
# dynamic_lstm), Adam(2e-3), bf16 AMP
FLUID_LSTM = dict(batch=64, seq=100, vocab=30000, emb=128, hidden=512,
                  layers=2, lr=2e-3)
# the book's sentiment nets (tests/test_understand_sentiment.py): vocab
# 120, batch 16, embedding and hidden 32
BOOK = dict(vocab=120, batch=16, emb=32, hid=32)
# the CRNN (paddle_tpu/models/ocr_crnn.py) at its own hidden width 48
OCR = dict(batch=32, height=32, width=128, classes=36, hidden=48)


def lstm_flops(cfg):
    """bench.py:838-846's forward FLOPs of a batch: per LSTM layer the
    input projection (E or H -> 4H) and the recurrent GEMM (H -> 4H) over
    every token, 2 FLOPs per MAC."""
    toks = cfg["batch"] * cfg["seq"]
    f, in_dim = 0.0, cfg["emb"]
    for _ in range(cfg["layers"]):
        f += 2.0 * toks * (in_dim * 4 * cfg["hidden"]
                           + cfg["hidden"] * 4 * cfg["hidden"])
        in_dim = cfg["hidden"]
    return f


def lstm_program(fluid, cfg, amp=True):
    """bench.py:800-825's program built with the port's API."""
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        words = fluid.layers.data(name="words", shape=[1], dtype="int64",
                                  lod_level=1)
        label = fluid.layers.data(name="label", shape=[1], dtype="int64")
        x = fluid.layers.embedding(input=words,
                                   size=[cfg["vocab"], cfg["emb"]])
        for _ in range(cfg["layers"]):
            proj = fluid.layers.fc(input=x, size=cfg["hidden"] * 4)
            x, _ = fluid.layers.dynamic_lstm(input=proj,
                                             size=cfg["hidden"] * 4)
        last = fluid.layers.sequence_last_step(input=x)
        predict = fluid.layers.fc(input=last, size=2, act="softmax")
        cost = fluid.layers.mean(
            x=fluid.layers.cross_entropy(input=predict, label=label))
        fluid.optimizer.Adam(learning_rate=cfg["lr"]).minimize(cost)
    main.amp = amp
    return main, startup, cost


def lstm_feed(torch, cfg, dev):
    """bench.py:829-835's batch: uniform offsets, RandomState(0); the
    tokens on the device, the offsets on the host."""
    rng = np.random.RandomState(0)
    B, T = cfg["batch"], cfg["seq"]
    tokens = rng.randint(0, cfg["vocab"], (B * T, 1)).astype(np.int64)
    offsets = np.arange(0, B * T + 1, T, dtype=np.int32)
    label = rng.randint(0, 2, (B, 1)).astype(np.int64)
    return {"words": (torch.from_numpy(tokens).to(dev), [offsets]),
            "label": torch.from_numpy(label).to(dev)}


def phase_fluid_lstm(torch, fluid, profile=False, warm=2, steps=10,
                     place=None, cfg=FLUID_LSTM):
    """Phase 20: the LSTM benchmark trained through the port's Fluid
    Executor on the card, bf16 AMP (`place` and `cfg` shrink it for a
    rehearsal on the CPU)."""
    main, startup, cost = lstm_program(fluid, cfg)
    scope = fluid.Scope()
    with fluid.scope_guard(scope):
        exe = fluid.Executor(place or fluid.CUDAPlace(0))
        dev = exe.device
        exe.run(startup)
        feed = lstm_feed(torch, cfg, dev)

        def step():
            return exe.run(main, feed=feed, fetch_list=[cost],
                           return_numpy=False)[0]

        t0 = time.monotonic()
        losses = [step() for _ in range(warm)]
        _sync(torch, dev.type)
        warm_s = time.monotonic() - t0
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats()
        t0 = time.monotonic()
        losses += [step() for _ in range(steps)]
        _sync(torch, dev.type)
        wall = time.monotonic() - t0
        peak = torch.cuda.max_memory_allocated() if dev.type == "cuda" \
            else 0
        losses = [float(x.reshape(())) for x in losses]
        check(all(math.isfinite(x) for x in losses),
              "a Fluid LSTM loss is not finite: %s" % losses)
        tokens = cfg["batch"] * cfg["seq"]
        share = lstm_flops(cfg) * 3 / (wall / steps) / PEAK_FLOPS["bfloat16"]
        log("  warm-up %d steps %.1f s; losses %s" % (
            warm, warm_s, ", ".join("%.4f" % x for x in losses)))
        log("  %d steps of %d x %d tokens: %.3f ms/step, %.1f tokens/s, "
            "peak device memory %.3f GiB, FLOP share %.6f of 989 TFLOP/s "
            "(bench.py's count x 3)" % (
                steps, cfg["batch"], cfg["seq"], wall / steps * 1e3,
                tokens * steps / wall, peak / 2 ** 30, share))
        out = dict(ms_per_step=wall / steps * 1e3,
                   tokens_per_s=tokens * steps / wall,
                   peak_mem_gib=peak / 2 ** 30, flop_share=share,
                   losses=losses, warm_s=warm_s)
        if profile:
            out["profile"] = profile_fluid(torch, step, 3,
                                           "3 Fluid LSTM steps")
    del scope, exe, feed, step
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
    return out


def phase_lstm_sync(torch, cfg=FLUID_LSTM, dev="cuda"):
    """The lstm kernel alone, forward and backward, at phase 20's shapes
    (one layer, bf16 as under AMP) on device tensors whose offsets the
    host knows, under torch.cuda.set_sync_debug_mode("error"): any read
    of the device back to the host raises."""
    import types

    from paddle_tpu_torch.fluid.core.registry import (LoweringContext,
                                                      get_kernel)

    B, T, H = cfg["batch"], cfg["seq"], cfg["hidden"]
    g = torch.Generator(device=dev).manual_seed(20)

    def rand(*shape):
        return (0.1 * torch.randn(*shape, generator=g, device=dev)).to(
            torch.bfloat16).requires_grad_(True)

    x, w, b = rand(B * T, 4 * H), rand(H, 4 * H), rand(1, 7 * H)
    host = np.arange(0, B * T + 1, T, dtype=np.int32)
    off = torch.from_numpy(host).to(dev)
    ctx = LoweringContext(None, None, torch.device(dev))
    ctx.op = types.SimpleNamespace(
        type="lstm", inputs={"Input": ["x"], "Weight": ["w"],
                             "Bias": ["b"]},
        outputs={"Hidden": ["h"], "Cell": ["c"]})
    ctx.env = {"x@LOD0": off}
    ctx.note_host_lod(off, host)
    _sync(torch, dev)
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = get_kernel("lstm")(ctx, {"Input": [x], "Weight": [w],
                                       "Bias": [b]}, {})
        grads = torch.autograd.grad(out["Hidden"].float().sum(),
                                    [x, w, b])
    finally:
        torch.cuda.set_sync_debug_mode(0)
    _sync(torch, dev)
    finite = all(bool(torch.isfinite(t).all()) for t in
                 [out["Hidden"], out["Cell"]] + list(grads))
    log("  lstm forward and backward at [%d x %d, 4x%d] bf16: no host "
        "sync; outputs and gradients finite: %s" % (B, T, H, finite))
    check(finite, "the lstm kernel's sync check gave non-finite values")
    return dict(no_host_sync=True, finite=finite)


def ragged_lengths(rng, n, lo, hi, one=True):
    """n lengths in [lo, hi] (with a 1 among them when `one`) and a
    maximum that is no power of two."""
    lens = rng.randint(lo, hi + 1, n)
    if one:
        lens[0] = 1
    while lens.max() & (lens.max() - 1) == 0:
        lens[int(np.argmax(lens))] -= 1
    return lens


def book_feed(rng, cfg=BOOK):
    lens = ragged_lengths(rng, cfg["batch"], 3, 20)
    toks = rng.randint(0, cfg["vocab"], (int(lens.sum()), 1)).astype(
        np.int64)
    lod = np.cumsum([0] + list(lens)).astype(np.int32)
    labels = rng.randint(0, 2, (cfg["batch"], 1)).astype(np.int64)
    return {"words": (toks, [lod]), "label": labels}, lens


def ocr_batch(rng, cfg, lo=4, hi=12, one=False):
    """Images whose column bands encode their labels (as
    tests/test_mobilenet_ocr.py's _ocr_batch), ragged labels of lo..hi
    ids."""
    n, W = cfg["batch"], cfg["width"]
    imgs = 0.05 * rng.rand(n, 1, cfg["height"], W).astype(np.float32)
    lens = ragged_lengths(rng, n, lo, hi, one)
    labels = []
    for i, ln in enumerate(lens):
        lab = rng.randint(0, cfg["classes"], ln)
        step = W // ln
        for j, c in enumerate(lab):
            imgs[i, 0, :, j * step:j * step + step // 2] += \
                0.2 + 0.6 * c / cfg["classes"]
        labels.extend(lab)
    lod = np.cumsum([0] + list(lens)).astype(np.int32)
    return imgs, (np.asarray(labels, np.int64).reshape(-1, 1), [lod]), lens


def book_nets(fluid, cfg=BOOK):
    """tests/test_understand_sentiment.py:36-80's two nets."""
    def conv(data, label):
        emb = fluid.layers.embedding(input=data,
                                     size=[cfg["vocab"], cfg["emb"]])
        towers = [fluid.nets.sequence_conv_pool(
            input=emb, num_filters=cfg["hid"], filter_size=k, act="tanh",
            pool_type="sqrt") for k in (3, 4)]
        return fluid.layers.fc(input=towers, size=2, act="softmax")

    def stacked_lstm(data, label, stacked_num=3):
        emb = fluid.layers.embedding(input=data,
                                     size=[cfg["vocab"], cfg["emb"]])
        fc1 = fluid.layers.fc(input=emb, size=cfg["hid"])
        lstm1, _ = fluid.layers.dynamic_lstm(input=fc1, size=cfg["hid"])
        inputs = [fc1, lstm1]
        for i in range(2, stacked_num + 1):
            fc = fluid.layers.fc(input=inputs, size=cfg["hid"])
            lstm, _ = fluid.layers.dynamic_lstm(
                input=fc, size=cfg["hid"], is_reverse=(i % 2) == 0)
            inputs = [fc, lstm]
        pooled = [fluid.layers.sequence_pool(input=v, pool_type="max")
                  for v in inputs]
        return fluid.layers.fc(input=pooled, size=2, act="softmax")

    return {"stacked_lstm_net": stacked_lstm, "convolution_net": conv}


def ragged_programs(fluid, crnn):
    """(name, main, startup, loss, feed, lengths) of phase 21's three
    programs, f32, Momentum(lr, 0.9): lr 0.05 for the book's nets, 0.002
    for the CRNN (whose summed CTC losses have large gradients)."""
    out = []
    rng = np.random.RandomState(21)
    for name, net in sorted(book_nets(fluid).items()):
        main, startup = fluid.Program(), fluid.Program()
        with fluid.program_guard(main, startup):
            data = fluid.layers.data(name="words", shape=[1],
                                     dtype="int64", lod_level=1)
            label = fluid.layers.data(name="label", shape=[1],
                                      dtype="int64")
            loss = fluid.layers.mean(x=fluid.layers.cross_entropy(
                input=net(data, label), label=label))
            fluid.optimizer.Momentum(learning_rate=0.05,
                                     momentum=0.9).minimize(loss)
        feed, lens = book_feed(rng)
        out.append((name, main, startup, loss, feed, lens))
    cfg = dict(OCR, batch=8)
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        img = fluid.layers.data(name="img", shape=[1, cfg["height"],
                                                   cfg["width"]],
                                dtype="float32")
        lab = fluid.layers.data(name="lab", shape=[1], dtype="int64",
                                lod_level=1)
        loss, _ = crnn.crnn_ctc(img, lab, num_classes=cfg["classes"],
                                hidden=cfg["hidden"])
        fluid.optimizer.Momentum(learning_rate=0.002,
                                 momentum=0.9).minimize(loss)
    imgs, labels, lens = ocr_batch(rng, cfg, one=True)
    out.append(("crnn_ctc", main, startup, loss,
                {"img": imgs, "lab": labels}, lens))
    return out


def phase_ragged_parity(torch, fluid, crnn, steps=3, place=None):
    """Phase 21: the book's stacked_lstm_net (3 layers, alternating
    is_reverse) and convolution_net and the CRNN, f32, 3 Momentum steps
    from one set of startup weights on the card (TF32 off, as main()
    sets) and on the CPU, fed ragged lengths from a seed (a 1 among
    them, a maximum that is no power of two). Losses within rtol 1e-4,
    parameters within atol 1e-4."""
    results = {}
    for name, main, startup, loss, feed, lens in ragged_programs(fluid,
                                                                 crnn):
        init = fluid.Scope()
        with fluid.scope_guard(init):
            fluid.Executor(fluid.CPUPlace()).run(startup)
        init = fluid.scope_to_numpy(init)
        runs = {}
        for side, where in (("card", place or fluid.CUDAPlace(0)),
                            ("cpu", fluid.CPUPlace())):
            exe = fluid.Executor(where)
            scope = fluid.scope_from_numpy(fluid.Scope(), init, exe.device)
            with fluid.scope_guard(scope):
                losses = [float(np.ravel(exe.run(
                    main, feed=feed, fetch_list=[loss])[0])[0])
                    for _ in range(steps)]
            runs[side] = (losses, fluid.scope_to_numpy(scope))
        (lc, sc), (lh, sh) = runs["card"], runs["cpu"]
        params = [p.name for p in main.global_block().all_parameters()]
        loss_err = max(abs(a - b) / abs(b) for a, b in zip(lc, lh))
        p_err = max(float(np.abs(sc[n] - sh[n]).max()) for n in params)
        moved = max(float(np.abs(sh[n] - init[n]).max()) for n in params)
        ok = loss_err <= 1e-4 and p_err <= 1e-4 and all(
            math.isfinite(x) for x in lc)
        log("  %s (lengths %d..%d, max %d): losses card %s vs CPU %s; max "
            "rel loss diff %.3e, max param diff %.3e (moved up to %.3e) %s"
            % (name, int(lens.min()), int(lens.max()), int(lens.max()),
               ["%.6f" % x for x in lc], ["%.6f" % x for x in lh],
               loss_err, p_err, moved, "ok" if ok else "FAIL"))
        check(ok, "%s: f32 training on the card diverged from the CPU"
              % name)
        results[name] = dict(loss_rel_err=loss_err, param_abs_err=p_err)
    return results


def phase_crnn(torch, fluid, crnn, steps=6, place=None, cfg=OCR):
    """Phase 22: the CRNN at its own width (hidden 48) on images
    [32, 1, 32, 128] with ragged labels of 4-12 ids, f32 SGD(0.002) on
    one fixed batch: losses finite and falling; then the greedy decode of
    the trained weights through the for_test clone."""
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        img = fluid.layers.data(name="img", shape=[1, cfg["height"],
                                                   cfg["width"]],
                                dtype="float32")
        lab = fluid.layers.data(name="lab", shape=[1], dtype="int64",
                                lod_level=1)
        loss, logits = crnn.crnn_ctc(img, lab, num_classes=cfg["classes"],
                                     hidden=cfg["hidden"])
        decoded = crnn.greedy_decode(logits, cfg["classes"])
        infer = main.clone(for_test=True)
        fluid.optimizer.SGD(learning_rate=0.002).minimize(loss)
    imgs, labels, lens = ocr_batch(np.random.RandomState(22), cfg)
    scope = fluid.Scope()
    with fluid.scope_guard(scope):
        exe = fluid.Executor(place or fluid.CUDAPlace(0))
        exe.run(startup)
        feed = {"img": imgs, "lab": labels}
        t0 = time.monotonic()
        losses = [float(np.ravel(exe.run(main, feed=feed,
                                         fetch_list=[loss])[0])[0])
                  for _ in range(steps)]
        _sync(torch, exe.device.type)
        ms = (time.monotonic() - t0) / steps * 1e3
        dec = exe.run(infer, feed={"img": imgs}, fetch_list=[decoded])[0]
    ok = all(math.isfinite(x) for x in losses) and losses[-1] < losses[0]
    valid = bool(((dec >= 0) & (dec < cfg["classes"])).all())
    log("  labels of %d..%d ids; losses %s; %.1f ms/step (f32, incl. "
        "fetch); greedy decode %s, ids in range: %s %s" % (
            int(lens.min()), int(lens.max()),
            ", ".join("%.4f" % x for x in losses), ms, list(dec.shape),
            valid, "ok" if ok and valid else "FAIL"))
    check(ok, "the CRNN's losses are not finite or did not fall: %s"
          % losses)
    check(valid, "the CRNN's greedy decode emitted ids out of range")
    return dict(losses=losses, ms_per_step=ms,
                decoded_shape=list(dec.shape))


# ---------------------------------------------------------------------
# phases 23-24: control flow through the Fluid port
# ---------------------------------------------------------------------

# the PaddlePaddle book's machine-translation chapter (wmt14): source
# and target dictionaries of 30000, word vectors 512, encoder and
# decoder width 512 (fc and dynamic_lstm at 4 x 512), beam 3; the Fluid
# book program's topk k 10 (tests/test_machine_translation.py:100);
# batch 64 sentence pairs of 10-50 source tokens from the synthetic
# reverse-copy corpus (RandomState(0)); decode capped at 64 trips (the
# book's max_length is 250). Adagrad at lr 1e-3: its first step moves
# every parameter with a gradient by about lr, so the JAX test's lr 0.2
# (at width 32) moves each of the 30000 logits by up to ~0.2 x 512 at
# this width and saturates the softmax in one step (losses 10.31 ->
# 18.17, the cap of -log(1e-8), on the H100)
NMT = dict(dict_size=30000, word=512, hidden=512, beam=3, topk=10,
           batch=64, lo=10, hi=50, max_len=64, lr=1e-3)
# the JAX suite's widths (tests/test_machine_translation.py)
NMT_TEST = dict(dict_size=40, word=16, hidden=32, beam=2, topk=10,
                batch=8, lo=2, hi=4, max_len=6, lr=0.2)
NMT_START, NMT_END = 1, 2


def wmt_batch(cfg, seed):
    """tests/test_machine_translation.py's synthetic_wmt at `cfg`'s
    dictionary and lengths: (src, <s>+reversed, reversed+<e>) triples."""
    rng = np.random.RandomState(seed)
    data = []
    for _ in range(cfg["batch"]):
        src = rng.randint(3, cfg["dict_size"],
                          size=rng.randint(cfg["lo"], cfg["hi"] + 1))
        rev = src[::-1].tolist()
        data.append((src.tolist(), [NMT_START] + rev, rev + [NMT_END]))
    return data


def lod_pair(torch, seqs, dev, dtype=np.int64):
    """(packed [total, 1] on `dev`, [host offsets]) of a list of id
    sequences."""
    off = np.cumsum([0] + [len(s) for s in seqs]).astype(np.int32)
    flat = np.concatenate([np.asarray(s) for s in seqs]).astype(dtype)
    return torch.from_numpy(flat.reshape(-1, 1)).to(dev), [off]


def nmt_encoder(fluid, cfg):
    """The book's encoder: embedding -> fc(4H, tanh) -> dynamic_lstm(4H)
    -> sequence_last_step."""
    pd = fluid.layers
    src = pd.data(name="src_word_id", shape=[1], dtype="int64", lod_level=1)
    emb = pd.embedding(input=src, size=[cfg["dict_size"], cfg["word"]],
                       dtype="float32",
                       param_attr=fluid.ParamAttr(name="vemb"))
    fc1 = pd.fc(input=emb, size=cfg["hidden"] * 4, act="tanh")
    hidden, _ = pd.dynamic_lstm(input=fc1, size=cfg["hidden"] * 4)
    return pd.sequence_last_step(input=hidden)


def nmt_train_program(fluid, cfg, lr=None):
    """tests/test_machine_translation.py:29-63: the training decoder is
    a DynamicRNN over the target words, its memory booted from the
    encoder's context; cross_entropy -> mean, Adagrad."""
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        pd = fluid.layers
        context = nmt_encoder(fluid, cfg)
        trg = pd.data(name="target_language_word", shape=[1],
                      dtype="int64", lod_level=1)
        trg_emb = pd.embedding(input=trg,
                               size=[cfg["dict_size"], cfg["word"]],
                               dtype="float32",
                               param_attr=fluid.ParamAttr(name="vemb"))
        rnn = pd.DynamicRNN()
        with rnn.block():
            word = rnn.step_input(trg_emb)
            pre = rnn.memory(init=context)
            state = pd.fc(input=[word, pre], size=cfg["hidden"],
                          act="tanh")
            score = pd.fc(input=state, size=cfg["dict_size"],
                          act="softmax")
            rnn.update_memory(pre, state)
            rnn.output(score)
        label = pd.data(name="target_language_next_word", shape=[1],
                        dtype="int64", lod_level=1)
        loss = pd.mean(x=pd.cross_entropy(input=rnn(), label=label))
        fluid.optimizer.Adagrad(
            learning_rate=cfg["lr"] if lr is None else lr).minimize(loss)
    return main, startup, loss


def decode_loop(fluid, init_state, V, D, H, T, beam, k, emb_attr,
                names=("dec", "out")):
    """tests/test_machine_translation.py:66-113's decoder: a While over
    tensor arrays (array_read -> sequence_expand over the beam parents
    -> embedding + fc -> topk -> beam_search -> increment ->
    array_write -> less_than), then beam_search_decode. Returns the
    decode's ids, scores, lengths, loop counter and state array."""
    pd = fluid.layers
    init_ids = pd.data(name="init_ids", shape=[1], dtype="int64",
                       lod_level=2)
    init_scores = pd.data(name="init_scores", shape=[1], dtype="float32",
                          lod_level=2)
    array_len = pd.fill_constant(shape=[1], dtype="int64", value=T)
    counter = pd.zeros(shape=[1], dtype="int64", force_cpu=True)
    state_array = pd.create_array("float32")
    pd.array_write(init_state, array=state_array, i=counter)
    ids_array = pd.create_array("int64")
    scores_array = pd.create_array("float32")
    pd.array_write(init_ids, array=ids_array, i=counter)
    pd.array_write(init_scores, array=scores_array, i=counter)
    cond = pd.less_than(x=counter, y=array_len)
    w = pd.While(cond=cond)
    with w.block():
        pre_ids = pd.array_read(array=ids_array, i=counter)
        pre_state = pd.array_read(array=state_array, i=counter)
        pre_score = pd.array_read(array=scores_array, i=counter)
        expanded = pd.sequence_expand(pre_state, pre_score)
        emb = pd.embedding(input=pre_ids, size=[V, D], dtype="float32",
                           param_attr=fluid.ParamAttr(name=emb_attr))
        state = pd.fc(input=[emb, expanded], size=H, act="tanh",
                      param_attr=fluid.ParamAttr(name=names[0]))
        score = pd.fc(input=state, size=V, act="softmax",
                      param_attr=fluid.ParamAttr(name=names[1]))
        top_scores, top_ids = pd.topk(score, k=k)
        sel_ids, sel_scores = pd.beam_search(pre_ids, top_ids, top_scores,
                                             beam, end_id=NMT_END)
        pd.increment(x=counter, value=1, in_place=True)
        pd.array_write(state, array=state_array, i=counter)
        pd.array_write(sel_ids, array=ids_array, i=counter)
        pd.array_write(sel_scores, array=scores_array, i=counter)
        pd.less_than(x=counter, y=array_len, cond=cond)
    ids, scores = pd.beam_search_decode(ids=ids_array, scores=scores_array)
    lens = fluid.default_main_program().global_block().var(ids.lens_name)
    return dict(ids=ids, lens=lens, counter=counter, scores=scores)


def nmt_decode_program(fluid, cfg):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        out = decode_loop(fluid, nmt_encoder(fluid, cfg), cfg["dict_size"],
                          cfg["word"], cfg["hidden"], cfg["max_len"],
                          cfg["beam"], cfg["topk"], "vemb")
    return main, startup, out


def nmt_decode_feed(torch, cfg, data, dev):
    """The sources on `dev` and one <s> per source as a 2-level LoD
    feed (init ids and scores)."""
    B = len(data)
    lod = [list(range(B + 1))] * 2
    return {"src_word_id": lod_pair(torch, [d[0] for d in data], dev),
            "init_ids": (torch.full((B, 1), NMT_START, dtype=torch.int64,
                                    device=dev), lod),
            "init_scores": (torch.ones((B, 1), device=dev), lod)}


def nmt_train_feed(torch, data, dev):
    return {"src_word_id": lod_pair(torch, [d[0] for d in data], dev),
            "target_language_word": lod_pair(torch, [d[1] for d in data],
                                             dev),
            "target_language_next_word": lod_pair(
                torch, [d[2] for d in data], dev)}


def control_programs(fluid):
    """(name, main, startup, fetches, feed) of phase 23's IfElse, Switch
    and StaticRNN programs (tests/test_torch_fluid_control.py's) and a
    row of ties through top_k."""
    rng = np.random.RandomState(23)
    out = []
    pd = fluid.layers

    def program(name, build, feed):
        main, startup = fluid.Program(), fluid.Program()
        with fluid.program_guard(main, startup):
            fetches = build()
        out.append((name, main, startup, fetches, feed))

    def ifelse():
        x = pd.data(name="x", shape=[2], dtype="float32")
        c = pd.data(name="c", shape=[1], dtype="bool")
        ie = pd.IfElse(c)
        with ie.true_block():
            ie.output(pd.tanh(x=pd.scale(x=ie.input(x), scale=3.0)))
        with ie.false_block():
            ie.output(pd.scale(x=pd.exp(x=ie.input(x)), scale=2.0,
                               bias=-1.0))
        return list(ie())

    program("ifelse", ifelse, {"x": rng.randn(64, 2).astype(np.float32),
                               "c": rng.rand(64, 1) > 0.5})

    def switch():
        step = pd.data(name="s", shape=[1], dtype="float32")
        lr = pd.fill_constant(shape=[1], dtype="float32", value=0.8)
        one = pd.fill_constant(shape=[1], dtype="float32", value=1.0)
        with pd.Switch() as sw:
            with sw.case(pd.less_than(step, one)):
                pd.assign(pd.scale(x=lr, scale=0.5), lr)
            with sw.default():
                pd.assign(pd.fill_constant(shape=[1], dtype="float32",
                                           value=0.3), lr)
        return [pd.scale(x=lr, scale=1.0)]

    program("switch", switch, {"s": np.array([[0.5]], np.float32)})

    def static_rnn(T=5, N=16, D=32):
        x = pd.data(name="x", shape=[T, N, D], dtype="float32",
                    append_batch_size=False)
        h0 = pd.fill_constant(shape=[N, D], dtype="float32", value=0.0)
        rnn = pd.StaticRNN()
        with rnn.step():
            xt = rnn.step_input(x)
            hprev = rnn.memory(init=h0)
            w = pd.create_parameter([D, D], "float32", attr="srnn_w")
            h = pd.tanh(x=pd.elementwise_add(x=pd.matmul(x=xt, y=w),
                                             y=pd.matmul(x=hprev, y=w)))
            rnn.update_memory(hprev, h)
            rnn.step_output(h)
        return [rnn()]

    program("static_rnn", static_rnn,
            {"x": rng.randn(5, 16, 32).astype(np.float32)})

    def ties():
        x = pd.data(name="x", shape=[40], dtype="float32")
        vals, idx = pd.topk(x, k=10)
        return [vals, idx]

    tie = np.zeros((3, 40), np.float32)
    tie[0, 20] = 1.0
    tie[1, ::3] = 0.5
    tie[2] = rng.randint(0, 3, 40)
    program("top_k ties", ties, {"x": tie})
    return out


def _card_and_cpu(fluid, startup, run, place=None, init=None):
    """`run(exe)` on the card and on the CPU from one set of startup
    weights (the CPU startup's, or `init` laid over them); returns
    {side: (run's result, final scope as numpy)}."""
    scope0 = fluid.Scope()
    with fluid.scope_guard(scope0):
        fluid.Executor(fluid.CPUPlace()).run(startup)
    weights = dict(fluid.scope_to_numpy(scope0), **(init or {}))
    out = {}
    for side, where in (("card", place or fluid.CUDAPlace(0)),
                        ("cpu", fluid.CPUPlace())):
        exe = fluid.Executor(where)
        scope = fluid.scope_from_numpy(fluid.Scope(), weights, exe.device)
        with fluid.scope_guard(scope):
            res = run(exe)
        out[side] = (res, fluid.scope_to_numpy(scope))
    return out, weights


def phase_control_parity(torch, fluid, place=None, steps=3):
    """Phase 23: control flow in f32, card vs CPU in one process. The
    book's NMT at the JAX suite's widths trains 3 Adagrad steps from one
    set of startup weights: at lr 0.01 losses within rtol 1e-4 and
    parameters within atol 1e-4; at the book's lr 0.2 the losses
    (Adagrad's lr*g/(|g|+1e-6) turns an f32 rounding difference in a
    near-zero gradient into up to 2e5 times it in the parameter). Its
    beam decode, a beam loop whose beams all end early (the exit on),
    and IfElse / Switch / StaticRNN / top_k ties: ids, lengths, the
    fetched counter and top_k indices exact, values within 1e-5."""
    from paddle_tpu_torch.fluid.core import kernels_control as kc

    results = {}
    data = wmt_batch(NMT_TEST, 1)
    for lr, hold in ((0.01, True), (0.2, False)):
        main, startup, loss = nmt_train_program(fluid, NMT_TEST, lr)

        def train(exe):
            feed = nmt_train_feed(torch, data, exe.device)
            return [float(np.ravel(exe.run(main, feed=feed,
                                           fetch_list=[loss])[0])[0])
                    for _ in range(steps)]

        runs, init = _card_and_cpu(fluid, startup, train, place)
        (lc, sc), (lh, sh) = runs["card"], runs["cpu"]
        params = [p.name for p in main.global_block().all_parameters()]
        loss_err = max(abs(a - b) / abs(b) for a, b in zip(lc, lh))
        p_err = max(float(np.abs(sc[n] - sh[n]).max()) for n in params)
        moved = max(float(np.abs(sh[n] - init[n]).max()) for n in params)
        ok = loss_err <= 1e-4 and (p_err <= 1e-4 or not hold) and all(
            math.isfinite(x) for x in lc)
        label = "nmt train, Adagrad(%g)" % lr
        log("  %s: losses card %s vs CPU %s; max rel loss diff %.3e, max "
            "param diff %.3e%s (moved up to %.3e) %s" % (
                label, ["%.6f" % x for x in lc], ["%.6f" % x for x in lh],
                loss_err, p_err, "" if hold else " (not held)", moved,
                "ok" if ok else "FAIL"))
        check(ok, "%s: card diverged from the CPU" % label)
        results[label] = dict(loss_rel_err=loss_err, param_abs_err=p_err)

    def held_decode(label, main, startup, out, feed_fn, init=None):
        def decode(exe):
            got = exe.run(main, feed=feed_fn(exe.device),
                          fetch_list=[out[k] for k in
                                      ("ids", "lens", "counter", "scores")])
            return got, dict(kc.LAST_WHILE_STATS)

        runs, _ = _card_and_cpu(fluid, startup, decode, place, init)
        (c, cstats), (h, hstats) = runs["card"][0], runs["cpu"][0]
        exact = all(np.array_equal(a, b) for a, b in zip(c[:3], h[:3]))
        s_err = float(np.abs(c[3] - h[3]).max())
        ok = exact and s_err <= 1e-5 and cstats == hstats
        log("  %s: ids %s, counter %d, trips %s; ids, lengths and counter "
            "equal: %s, max score diff %.3e %s" % (
                label, list(c[0].shape), int(np.ravel(c[2])[0]), cstats,
                exact, s_err, "ok" if ok else "FAIL"))
        check(ok, "%s: the card's decode differs from the CPU's" % label)
        results[label] = dict(score_abs_err=s_err, counter=int(
            np.ravel(c[2])[0]), stats=cstats)
        return cstats

    main, startup, out = nmt_decode_program(fluid, NMT_TEST)
    held_decode("nmt decode", main, startup, out,
                lambda dev: nmt_decode_feed(torch, NMT_TEST, data, dev))

    V, D, H, T_MAX = 7, 4, 5, 24
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        state = fluid.layers.data(name="init_state", shape=[H],
                                  dtype="float32")
        out = decode_loop(fluid, state, V, D, H, T_MAX, 2, 5, "ee_emb",
                          ("ee_dec", "ee_out"))
    rng = np.random.RandomState(9)
    init_state = rng.randn(2, H).astype(np.float32)
    rigged = np.zeros((H, V), np.float32)
    rigged[:, NMT_END] = 4.0  # end_id wins every softmax: beams end early

    def beam_feed(dev):
        lod = [[0, 1, 2]] * 2
        return {"init_state": torch.from_numpy(init_state).to(dev),
                "init_ids": (torch.full((2, 1), NMT_START,
                                        dtype=torch.int64, device=dev), lod),
                "init_scores": (torch.ones((2, 1), device=dev), lod)}

    stats = held_decode("beam loop, early exit", main, startup, out,
                        beam_feed, init={"ee_out": rigged})
    check(stats["early_exit_armed"] and results["beam loop, early exit"][
        "counter"] < T_MAX // 2, "the beam loop did not exit early: %s"
        % stats)

    for name, main, startup, fetches, feed in control_programs(fluid):
        def run(exe):
            return exe.run(main, feed=feed, fetch_list=fetches)

        runs, _ = _card_and_cpu(fluid, startup, run, place)
        c, h = runs["card"][0], runs["cpu"][0]
        if name == "top_k ties":
            ok = np.array_equal(c[1], h[1]) and c[1][0].tolist() == [
                20, 0, 1, 2, 3, 4, 5, 6, 7, 8]
            err = float(np.abs(c[0] - h[0]).max())
        else:
            err = max(float(np.abs(a - b).max()) for a, b in zip(c, h))
            ok = err <= 1e-5
        log("  %s: max diff card vs CPU %.3e %s" % (
            name, err, "ok" if ok else "FAIL"))
        check(ok, "%s: the card differs from the CPU" % name)
        results[name] = dict(abs_err=err)
    return results


def _count_syncs(torch, fn):
    """(fn(), the number of synchronizing CUDA calls it made):
    torch.cuda.set_sync_debug_mode("warn") warns at each."""
    import warnings

    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    n = sum("synchroniz" in str(w.message) for w in seen)
    return out, n


def phase_nmt(torch, fluid, profile=False, warm=2, steps=10, place=None,
              cfg=NMT):
    """Phase 24: the book's NMT at full width on the card (`place` and
    `cfg` shrink it for a rehearsal on the CPU): 2 warm-up and 10 timed
    f32 Adagrad steps ending in a sync, then one more training step
    under torch.cuda.set_sync_debug_mode("error"); then beam decodes of
    the batch's 64 sources (one warm-up, 3 timed), and one with its
    synchronizing calls counted: at most one per trip after the peel."""
    from paddle_tpu_torch.fluid.core import kernels_control as kc

    data = wmt_batch(cfg, 0)
    main, startup, loss = nmt_train_program(fluid, cfg)
    out = {}
    scope = fluid.Scope()
    with fluid.scope_guard(scope):
        exe = fluid.Executor(place or fluid.CUDAPlace(0))
        dev = exe.device
        exe.run(startup)
        feed = nmt_train_feed(torch, data, dev)

        def step():
            return exe.run(main, feed=feed, fetch_list=[loss],
                           return_numpy=False)[0]

        t0 = time.monotonic()
        losses = [step() for _ in range(warm)]
        _sync(torch, dev.type)
        warm_s = time.monotonic() - t0
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats()
        t0 = time.monotonic()
        losses += [step() for _ in range(steps)]
        _sync(torch, dev.type)
        wall = time.monotonic() - t0
        peak = torch.cuda.max_memory_allocated() if dev.type == "cuda" \
            else 0
        losses = [float(x.reshape(())) for x in losses]
        tokens = sum(len(d[1]) for d in data)
        src_tokens = sum(len(d[0]) for d in data)
        check(all(math.isfinite(x) for x in losses) and losses[-1] <
              losses[0], "the NMT's losses are not finite or did not "
              "fall: %s" % losses)
        log("  warm-up %d steps %.1f s; losses %s" % (
            warm, warm_s, ", ".join("%.4f" % x for x in losses)))
        log("  %d steps of %d pairs (%d source, %d target tokens): %.3f "
            "ms/step, %.1f target tokens/s, peak device memory %.3f GiB"
            % (steps, len(data), src_tokens, tokens, wall / steps * 1e3,
               tokens * steps / wall, peak / 2 ** 30))
        out["train"] = dict(ms_per_step=wall / steps * 1e3,
                            target_tokens_per_s=tokens * steps / wall,
                            target_tokens=tokens, source_tokens=src_tokens,
                            peak_mem_gib=peak / 2 ** 30, losses=losses,
                            warm_s=warm_s)
        if dev.type == "cuda":
            _sync(torch, "cuda")
            torch.cuda.set_sync_debug_mode("error")
            try:
                last = step()
            finally:
                torch.cuda.set_sync_debug_mode(0)
            check(math.isfinite(float(last.reshape(()))),
                  "the NMT's sync-checked step gave a non-finite loss")
            log("  training step under set_sync_debug_mode('error'): no "
                "host sync")
            out["train"]["no_host_sync"] = True
        if profile:
            out["train"]["profile"] = profile_fluid(
                torch, step, 3, "3 Fluid NMT training steps")
    del scope, exe, feed, step

    dmain, dstartup, dout = nmt_decode_program(fluid, cfg)
    scope = fluid.Scope()
    with fluid.scope_guard(scope):
        exe = fluid.Executor(place or fluid.CUDAPlace(0))
        exe.run(dstartup)
        dfeed = nmt_decode_feed(torch, cfg, data, dev)
        fetch = [dout[k] for k in ("ids", "lens", "counter", "scores")]

        def decode():
            return exe.run(dmain, feed=dfeed, fetch_list=fetch,
                           return_numpy=False)

        decode()
        _sync(torch, dev.type)
        n = 3
        t0 = time.monotonic()
        for _ in range(n):
            got = decode()
        _sync(torch, dev.type)
        ms = (time.monotonic() - t0) / n * 1e3
        stats = dict(kc.LAST_WHILE_STATS)
        ids, lens, counter, scores = [fluid.as_numpy(t) for t in got]
        B = len(data)
        ok = ids.shape == (B * cfg["beam"], cfg["max_len"] + 1) and bool(
            (ids[:, 0] == NMT_START).all()) and bool(
            ((ids >= 0) & (ids < cfg["dict_size"])).all()) and bool(
            np.isfinite(scores).all())
        log("  beam decode of %d sources (beam %d, at most %d trips): "
            "%.3f ms per decode, %.1f sentences/s; trips %d (peeled %d, "
            "%d of %d after the peel, early exit armed: %s); mean output "
            "length %.2f; ids %s %s" % (
                B, cfg["beam"], cfg["max_len"], ms, B / (ms / 1e3),
                int(np.ravel(counter)[0]), stats["peeled"],
                stats["executed"], stats["remaining"],
                stats["early_exit_armed"], float(lens.mean()),
                list(ids.shape), "ok" if ok else "FAIL"))
        check(ok, "the NMT's beam decode gave malformed output")
        out["decode"] = dict(ms_per_decode=ms,
                             sentences_per_s=B / (ms / 1e3),
                             trips=int(np.ravel(counter)[0]), stats=stats,
                             mean_len=float(lens.mean()))
        if dev.type == "cuda":
            _, syncs = _count_syncs(torch, decode)
            after_peel = kc.LAST_WHILE_STATS["remaining"]
            log("  decode with syncs counted: %d synchronizing calls, %d "
                "trips after the peel" % (syncs, after_peel))
            check(syncs <= after_peel, "the decode loop synchronized %d "
                  "times over %d trips after the peel" % (syncs, after_peel))
            out["decode"]["syncs"] = syncs
        if profile:
            out["decode"]["profile"] = profile_fluid(
                torch, decode, 1, "1 Fluid NMT beam decode")
    del scope, exe
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------
# phases 25-27: sparse gradients, sampled losses and the CTR models
# ---------------------------------------------------------------------

# bench.py:855-909's sparse-embedding benchmark, uncut: a [1M, 64]
# table, batch 4096 x 8 id fields, sum-pooled into a logistic head
SPARSE = dict(vocab=1_000_000, dim=64, batch=4096, fields=8)
SPARSE_OPTS = (("sgd", lambda f: f.optimizer.SGD(learning_rate=0.05)),
               ("adam", lambda f: f.optimizer.Adam(learning_rate=1e-3)))


def sparse_program(fluid, cfg, is_sparse, opt):
    """bench.py:867-884's program (the table named, so its optimizer
    state can be found)."""
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        ids = fluid.layers.data(name="ids", shape=[cfg["fields"]],
                                dtype="int64")
        y = fluid.layers.data(name="y", shape=[1], dtype="float32")
        emb = fluid.layers.embedding(
            input=ids, size=[cfg["vocab"], cfg["dim"]], is_sparse=is_sparse,
            param_attr=fluid.ParamAttr(name="emb_w"))
        pooled = fluid.layers.reduce_sum(emb, dim=1)
        pred = fluid.layers.fc(input=pooled, size=1, act=None)
        cost = fluid.layers.mean(
            x=fluid.layers.sigmoid_cross_entropy_with_logits(x=pred,
                                                             label=y))
        opt(fluid).minimize(cost)
    return main, startup, cost


def sparse_feed(torch, cfg, dev, seed=0):
    """bench.py:886-890's batch (RandomState(seed)) on `dev`."""
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, cfg["vocab"], (cfg["batch"], cfg["fields"]))
    y = (rng.rand(cfg["batch"], 1) > 0.5).astype(np.float32)
    return {"ids": torch.from_numpy(ids.astype(np.int64)).to(dev),
            "y": torch.from_numpy(y).to(dev)}


def _lazy_rows_held(torch, scope, exe, main, cost, cfg, dev):
    """One more lazy-Adam step on a new batch: the rows of the table and
    of both moments that the batch does not touch are bit-identical
    before and after, and the touched rows of each moved."""
    shape = (cfg["vocab"], cfg["dim"])
    names = sorted(n for n in scope.keys()
                   if tuple(scope.get(n).shape) == shape)
    before = {n: scope.get(n).clone() for n in names}
    feed = sparse_feed(torch, cfg, dev, seed=1)
    exe.run(main, feed=feed, fetch_list=[cost], return_numpy=False)
    touched = torch.zeros(cfg["vocab"], dtype=torch.bool, device=dev)
    touched[feed["ids"].reshape(-1)] = True
    kept = all(torch.equal(before[n][~touched], scope.get(n)[~touched])
               for n in names)
    moved = all(not torch.equal(before[n][touched], scope.get(n)[touched])
                for n in names)
    ok = len(names) == 3 and kept and moved
    log("  lazy Adam step on a new batch (%d touched rows): %s untouched "
        "rows bit-identical %s, touched rows moved %s %s" % (
            int(touched.sum()), "/".join(names), kept, moved,
            "ok" if ok else "FAIL"))
    check(ok, "lazy Adam moved an untouched row or missed a touched one")
    return dict(state=names, untouched_identical=kept, touched_moved=moved)


def phase_sparse_bench(torch, fluid, profile=False, warm=2, steps=10,
                       place=None, cfg=SPARSE):
    """Phase 25: bench.py's sparse-embedding benchmark through the port's
    Fluid executor, SGD(0.05) and Adam(1e-3), each with is_sparse True
    and False: 2 warm-up and 10 timed steps on one batch ending in a
    sync; ms/step, examples/s, touched rows/s (batch x fields), the
    peak device memory the timed steps add above the resident state
    (the sparse step must add less than one table), a sparse step under
    torch.cuda.set_sync_debug_mode("error"), and lazy Adam's untouched
    rows held bit-identical. `place` and `cfg` shrink it for a rehearsal
    on the CPU."""
    out = {}
    table = cfg["vocab"] * cfg["dim"] * 4
    rows = cfg["batch"] * cfg["fields"]
    for opt_name, opt in SPARSE_OPTS:
        for is_sparse in (True, False):
            label = "%s %s" % (opt_name, "sparse" if is_sparse else "dense")
            main, startup, cost = sparse_program(fluid, cfg, is_sparse, opt)
            scope = fluid.Scope()
            with fluid.scope_guard(scope):
                exe = fluid.Executor(place or fluid.CUDAPlace(0))
                dev = exe.device
                cuda = dev.type == "cuda"
                exe.run(startup)
                feed = sparse_feed(torch, cfg, dev)

                def step():
                    return exe.run(main, feed=feed, fetch_list=[cost],
                                   return_numpy=False)[0]

                losses = [step() for _ in range(warm)]
                _sync(torch, dev.type)
                resident = torch.cuda.memory_allocated() if cuda else 0
                if cuda:
                    torch.cuda.reset_peak_memory_stats()
                t0 = time.monotonic()
                losses += [step() for _ in range(steps)]
                _sync(torch, dev.type)
                wall = time.monotonic() - t0
                added = torch.cuda.max_memory_allocated() - resident \
                    if cuda else 0
                losses = [float(x.reshape(())) for x in losses]
                check(all(math.isfinite(x) for x in losses),
                      "%s: a loss is not finite: %s" % (label, losses))
                rec = dict(ms_per_step=wall / steps * 1e3,
                           examples_per_s=cfg["batch"] * steps / wall,
                           touched_rows_per_s=rows * steps / wall,
                           resident_mib=resident / 2 ** 20,
                           added_peak_mib=added / 2 ** 20, losses=losses)
                log("  %s: %.3f ms/step, %.1f examples/s, %.1f touched "
                    "rows/s; resident %.1f MiB, the steps add %.1f MiB at "
                    "peak (one table: %.1f MiB); losses %.5f -> %.5f" % (
                        label, rec["ms_per_step"], rec["examples_per_s"],
                        rec["touched_rows_per_s"], rec["resident_mib"],
                        rec["added_peak_mib"], table / 2 ** 20, losses[0],
                        losses[-1]))
                if is_sparse and cuda:
                    check(added < table, "%s: the step added %.1f MiB, "
                          "more than one table" % (label, added / 2 ** 20))
                    torch.cuda.set_sync_debug_mode("error")
                    try:
                        last = step()
                    finally:
                        torch.cuda.set_sync_debug_mode(0)
                    check(math.isfinite(float(last.reshape(()))),
                          "%s: the sync-checked step gave a non-finite "
                          "loss" % label)
                    log("  %s step under set_sync_debug_mode('error'): no "
                        "host sync" % label)
                    rec["no_host_sync"] = True
                if profile:
                    rec["profile"] = profile_fluid(torch, step, 3,
                                                   "3 %s steps" % label)
                if is_sparse and opt_name == "adam":
                    rec["lazy_rows"] = _lazy_rows_held(
                        torch, scope, exe, main, cost, cfg, dev)
                out[label] = rec
            del scope, exe, feed, step
            if torch.cuda.is_available():
                torch.cuda.empty_cache()
        speedup = out[opt_name + " dense"]["ms_per_step"] / \
            out[opt_name + " sparse"]["ms_per_step"]
        out[opt_name + " sparse speedup"] = speedup
        log("  %s: sparse over dense %.3fx" % (opt_name, speedup))
    return out


# tests/test_selected_rows.py's model (vocab 50, dim 6, duplicate ids
# and a padding_idx in every batch) and tests/test_ctc_sampled_ops.py's
# nce (V 40, D 8, 32 rows, 8 noise samples, Adam 0.05) and hsigmoid (8
# classes, D 6, 64 rows, Adam 0.1) programs
SPARSE_PARITY_OPTS = (
    ("sgd", lambda f: f.optimizer.SGD(learning_rate=0.2)),
    ("momentum", lambda f: f.optimizer.Momentum(learning_rate=0.1,
                                                momentum=0.9)),
    ("adagrad", lambda f: f.optimizer.Adagrad(learning_rate=0.3)),
    ("adam", lambda f: f.optimizer.Adam(learning_rate=0.05)))
# the book's word2vec (tests/test_word2vec.py's network with
# is_sparse=True, as the reference book builds it) at the book's widths
# over a synthetic 2000-word dictionary (imikolov is not in the repo)
WORD2VEC = dict(dict_size=2000, embed=32, hidden=256, n=5, batch=32,
                lr=0.1)


def embedding_parity_program(fluid, opt, vocab=50, dim=6, pad=3):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        ids = fluid.layers.data(name="ids", shape=[1], dtype="int64")
        y = fluid.layers.data(name="y", shape=[1], dtype="float32")
        emb = fluid.layers.embedding(
            input=ids, size=[vocab, dim], is_sparse=True, padding_idx=pad,
            param_attr=fluid.ParamAttr(
                name="emb_w",
                initializer=fluid.initializer.Normal(scale=0.2, seed=7)))
        pred = fluid.layers.fc(input=emb, size=1, act=None,
                               param_attr=fluid.ParamAttr(
                                   name="fc_w",
                                   initializer=fluid.initializer.Constant(
                                       0.5)))
        loss = fluid.layers.mean(
            x=fluid.layers.square_error_cost(input=pred, label=y))
        opt(fluid).minimize(loss)
    return main, startup, loss


def embedding_parity_batches(n, vocab=50, pad=3, batch=8):
    rng = np.random.RandomState(0)
    out = []
    for _ in range(n):
        ids = rng.randint(0, vocab, (batch, 1)).astype(np.int64)
        ids[1], ids[2] = ids[0], pad
        out.append({"ids": ids, "y": rng.uniform(
            -1, 1, (batch, 1)).astype(np.float32)})
    return out


def nce_program(fluid):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        x = fluid.layers.data(name="x", shape=[8], dtype="float32")
        y = fluid.layers.data(name="y", shape=[1], dtype="int64")
        cost = fluid.layers.nce(input=x, label=y, num_total_classes=40,
                                num_neg_samples=8)
        loss = fluid.layers.mean(x=cost)
        fluid.optimizer.Adam(learning_rate=0.05).minimize(loss)
        nce = [op for op in main.global_block().ops if op.type == "nce"][0]
        labels = main.global_block().var(nce.outputs["SampleLabels"][0])
    return main, startup, [loss, labels]


def hsigmoid_program(fluid):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        x = fluid.layers.data(name="x", shape=[6], dtype="float32")
        y = fluid.layers.data(name="y", shape=[1], dtype="int64")
        loss = fluid.layers.mean(x=fluid.layers.hsigmoid(
            input=x, label=y, num_classes=8))
        fluid.optimizer.Adam(learning_rate=0.1).minimize(loss)
    return main, startup, [loss]


def word2vec_program(fluid, cfg=WORD2VEC):
    """tests/test_word2vec.py's network: N-1 context words through one
    shared table, concat -> fc(hidden, sigmoid) -> fc(dict, softmax),
    cross_entropy -> mean, SGD."""
    pd = fluid.layers
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        words = [pd.data(name="w%d" % i, shape=[1], dtype="int64")
                 for i in range(cfg["n"] - 1)]
        nxt = pd.data(name="nextw", shape=[1], dtype="int64")
        embs = [pd.embedding(input=w, size=[cfg["dict_size"], cfg["embed"]],
                             dtype="float32", is_sparse=True,
                             param_attr="shared_w") for w in words]
        hidden = pd.fc(input=pd.concat(input=embs, axis=1),
                       size=cfg["hidden"], act="sigmoid")
        predict = pd.fc(input=hidden, size=cfg["dict_size"], act="softmax")
        loss = pd.mean(x=pd.cross_entropy(input=predict, label=nxt))
        fluid.optimizer.SGD(learning_rate=cfg["lr"]).minimize(loss)
    return main, startup, [loss]


def word2vec_feed(cfg=WORD2VEC, seed=0):
    """tests/test_word2vec.py's synthetic n-grams: the next word is the
    sum of the context modulo the dictionary."""
    rng = np.random.RandomState(seed)
    ctx = rng.randint(0, cfg["dict_size"], (cfg["batch"], cfg["n"] - 1))
    feed = {"w%d" % i: ctx[:, i:i + 1].astype(np.int64)
            for i in range(cfg["n"] - 1)}
    feed["nextw"] = (ctx.sum(1) % cfg["dict_size"]).reshape(-1, 1).astype(
        np.int64)
    return feed


def phase_sparse_parity(torch, fluid, place=None, steps=5):
    """Phase 26: f32, card vs CPU in one process, from one set of startup
    weights. The sparse embedding model 5 steps with each optimizer that
    has a sparse branch: tables and optimizer state within 1e-6. nce and
    hsigmoid 5 Adam steps each: losses within rtol 1e-5, nce's sampled
    labels identical. The book's word2vec (is_sparse) 3 SGD steps:
    losses within rtol 1e-5."""
    results = {}
    feeds = embedding_parity_batches(steps)
    for name, opt in SPARSE_PARITY_OPTS:
        main, startup, loss = embedding_parity_program(fluid, opt)

        def train(exe):
            return [float(np.ravel(exe.run(main, feed=f,
                                           fetch_list=[loss])[0])[0])
                    for f in feeds]

        runs, init = _card_and_cpu(fluid, startup, train, place)
        (lc, sc), (lh, sh) = runs["card"], runs["cpu"]
        err = max(float(np.abs(sc[n] - sh[n]).max()) for n in sh)
        loss_err = max(abs(a - b) / abs(b) for a, b in zip(lc, lh))
        moved = float(np.abs(sh["emb_w"] - init["emb_w"]).max())
        ok = err <= 1e-6 and all(math.isfinite(x) for x in lc)
        label = "sparse embedding, %s" % name
        log("  %s: %d steps, max table/state diff %.3e (table moved up to "
            "%.3e), max rel loss diff %.3e %s" % (
                label, steps, err, moved, loss_err, "ok" if ok else "FAIL"))
        check(ok, "%s: the card differs from the CPU" % label)
        results[label] = dict(state_abs_err=err, loss_rel_err=loss_err)

    rng = np.random.RandomState(3)
    x = rng.randn(32, 8).astype(np.float32)
    nce_feed = {"x": x, "y": ((np.abs(x.sum(1)) * 7).astype(np.int64)
                              % 40).reshape(-1, 1)}
    rng = np.random.RandomState(4)
    centers = rng.randn(8, 6).astype(np.float32) * 2
    hy = rng.randint(0, 8, 64)
    hs_feed = {"x": centers[hy] + 0.1 * rng.randn(64, 6).astype(np.float32),
               "y": hy.reshape(-1, 1).astype(np.int64)}
    for label, (main, startup, fetch), feed, n in (
            ("nce", nce_program(fluid), nce_feed, steps),
            ("hsigmoid", hsigmoid_program(fluid), hs_feed, steps),
            ("word2vec (book widths, is_sparse)", word2vec_program(fluid),
             word2vec_feed(), 3)):

        def train(exe):
            return [exe.run(main, feed=feed, fetch_list=fetch)
                    for _ in range(n)]

        runs, _ = _card_and_cpu(fluid, startup, train, place)
        c, h = runs["card"][0], runs["cpu"][0]
        lc = [float(np.ravel(r[0])[0]) for r in c]
        lh = [float(np.ravel(r[0])[0]) for r in h]
        loss_err = max(abs(a - b) / abs(b) for a, b in zip(lc, lh))
        same = all(np.array_equal(a[1], b[1]) for a, b in zip(c, h)) \
            if len(fetch) > 1 else True
        ok = loss_err <= 1e-5 and same and all(math.isfinite(v) for v in lc)
        log("  %s: %d steps, losses card %s vs CPU %s, max rel diff %.3e%s "
            "%s" % (label, n, ["%.6f" % v for v in lc],
                    ["%.6f" % v for v in lh], loss_err,
                    ", sampled labels identical" if len(fetch) > 1 and same
                    else "", "ok" if ok else "FAIL"))
        check(ok, "%s: the card differs from the CPU" % label)
        results[label] = dict(loss_rel_err=loss_err, losses=lc)
    return results


# DeepFM's Criteo setting (Guo et al. 2017): embeddings 10, deep layers
# (400, 400, 400), Adam(1e-3); Criteo's layout
# (paddle_tpu/v2/dataset/criteo.py:36-45): 26 id fields in disjoint
# 40000-id ranges (1,040,000 ids) and 13 dense features; batch 2048
CTR = dict(fields=26, per_field=40000, dense=13, embed=10,
           deep=(400, 400, 400), batch=2048, lr=1e-3)


def ctr_program(fluid, ctr, kind, cfg=CTR):
    """(main, startup, for_test clone, loss, auc) of `ctr.<kind>` over
    ids [B, 26] and dense [B, 13]."""
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        ids = fluid.layers.data(name="ids", shape=[cfg["fields"]],
                                dtype="int64")
        dense = fluid.layers.data(name="dense", shape=[cfg["dense"]],
                                  dtype="float32")
        y = fluid.layers.data(name="y", shape=[1], dtype="float32")
        loss, prob = getattr(ctr, kind)(
            ids, y, num_fields=cfg["fields"],
            vocab=cfg["fields"] * cfg["per_field"], embed_dim=cfg["embed"],
            deep_dims=cfg["deep"], dense_input=dense)
        auc = fluid.layers.auc(input=prob, label=y)
        test = main.clone(for_test=True)
        fluid.optimizer.Adam(learning_rate=cfg["lr"]).minimize(loss)
    return main, startup, test, loss, auc


def ctr_batch(torch, dev, seed, cfg=CTR):
    """Seeded ids (field f's ids in [f * 40000, (f + 1) * 40000)), dense
    features and labels with tests/test_ctr_models.py's signal: field
    0's id parity xor an interaction of fields 1 and 2, 10% noise."""
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, cfg["per_field"], (cfg["batch"], cfg["fields"])) \
        + np.arange(cfg["fields"]) * cfg["per_field"]
    signal = (ids[:, 0] % 2) ^ ((ids[:, 1] % 2) & (ids[:, 2] % 2))
    y = (signal ^ (rng.rand(cfg["batch"]) < 0.1)).astype(np.float32)
    dense = rng.randn(cfg["batch"], cfg["dense"]).astype(np.float32)
    return {"ids": torch.from_numpy(ids.astype(np.int64)).to(dev),
            "dense": torch.from_numpy(dense).to(dev),
            "y": torch.from_numpy(y.reshape(-1, 1)).to(dev)}


def phase_ctr(torch, fluid, ctr, profile=False, warm=2, steps=10, total=30,
              place=None, cfg=CTR):
    """Phase 27: Wide&Deep and DeepFM at full width in f32 on one fixed
    batch: 2 warm-up and 10 timed steps ending in a sync (ms/step,
    examples/s, peak device memory), then to 30 steps: the loss must
    fall; AUC of the last training step and of a held-out batch through
    the for_test clone."""
    out = {}
    for kind in ("wide_deep", "deepfm"):
        main, startup, test, loss, auc = ctr_program(fluid, ctr, kind, cfg)
        scope = fluid.Scope()
        with fluid.scope_guard(scope):
            exe = fluid.Executor(place or fluid.CUDAPlace(0))
            dev = exe.device
            exe.run(startup)
            feed = ctr_batch(torch, dev, 0, cfg)

            def step():
                return exe.run(main, feed=feed, fetch_list=[loss, auc],
                               return_numpy=False)

            t0 = time.monotonic()
            runs = [step() for _ in range(warm)]
            _sync(torch, dev.type)
            warm_s = time.monotonic() - t0
            if dev.type == "cuda":
                torch.cuda.reset_peak_memory_stats()
            t0 = time.monotonic()
            runs += [step() for _ in range(steps)]
            _sync(torch, dev.type)
            wall = time.monotonic() - t0
            peak = torch.cuda.max_memory_allocated() \
                if dev.type == "cuda" else 0
            runs += [step() for _ in range(total - warm - steps)]
            losses = [float(r[0].reshape(())) for r in runs]
            train_auc = float(runs[-1][1].reshape(()))
            held = exe.run(test, feed=ctr_batch(torch, dev, 1, cfg),
                           fetch_list=[loss, auc])
            held_loss, held_auc = (float(np.ravel(v)[0]) for v in held)
            ok = all(math.isfinite(x) for x in losses) and \
                np.mean(losses[-5:]) < np.mean(losses[:5])
            log("  %s: %d steps of %d: %.3f ms/step, %.1f examples/s, peak "
                "device memory %.3f GiB; losses %.5f -> %.5f over %d steps, "
                "train-batch AUC %.4f; held-out batch loss %.5f, AUC %.4f "
                "%s" % (kind, steps, cfg["batch"], wall / steps * 1e3,
                        cfg["batch"] * steps / wall, peak / 2 ** 30,
                        losses[0], losses[-1], total, train_auc, held_loss,
                        held_auc, "ok" if ok else "FAIL"))
            check(ok, "%s: the loss did not fall: %s" % (kind, losses))
            out[kind] = dict(ms_per_step=wall / steps * 1e3,
                             examples_per_s=cfg["batch"] * steps / wall,
                             peak_mem_gib=peak / 2 ** 30, warm_s=warm_s,
                             losses=losses, train_auc=train_auc,
                             held_out_auc=held_auc,
                             held_out_loss=held_loss)
            if profile:
                out[kind]["profile"] = profile_fluid(
                    torch, step, 3, "3 %s steps" % kind)
        del scope, exe, feed, step
        if torch.cuda.is_available():
            torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------
# phases 28-32: lrn, the image zoo, the CRF ops and the book's SRL, the
# detection ops and SSD, the learning-rate schedules and the evaluators
# ---------------------------------------------------------------------

# bench.py:198-205: forward FLOPs per 224x224 image
ZOO_FWD_FLOPS = {"alexnet": 1.43e9, "googlenet": 3.0e9, "vgg16": 15.47e9,
                 "mobilenet": 1.14e9}
# bench.py:4433-4445's cells: (batch, the reference's own img/s on a K40m
# where bench.py names one, benchmark/README.md:37,50)
ZOO_CELLS = {"alexnet": (128, 383.2), "googlenet": (128, 111.4),
             "vgg16": (64, None), "mobilenet": (128, None)}
# the two BASELINE.json configs the zoo adds: the book's recognize_digits
# (MNIST, LeNet) and image_classification (CIFAR-10, vgg16_bn_drop), each
# with the book's Adam(1e-3). The card-vs-CPU check runs VGG at batch 32:
# at batch 8 its fc batch norm normalises 8 values a channel, and two CPU
# runs that differ only in their thread count already part by more than
# the check's 1e-4 in 3 steps
BOOK_IMAGE = {"lenet_mnist": dict(shape=[1, 28, 28], classes=10, batch=64,
                                  parity_batch=8),
              "vgg16_bn_drop_cifar10": dict(shape=[3, 32, 32], classes=10,
                                            batch=128, parity_batch=32)}
# the book's label_semantic_roles at its published widths over conll05's
# dictionaries (44,068 words, 3,162 predicates, 59 IOB labels = 29 chunk
# types); batch 10 sentences of 10-60 tokens. The schedule's base rate is
# 5e-4: the book's 0.01 diverges to nan on these synthetic sentences, on
# the card and on the CPU alike
SRL = dict(word_dict=44068, pred_dict=3162, labels=59, mark_dict=2,
           word_dim=32, mark_dim=5, hidden=512, depth=8, batch=10, lo=10,
           hi=60, lr=5e-4, crf_lr=1e-3)
# ssd_detector at VOC's shape: [32, 3, 300, 300], 20 classes + background
SSD = dict(size=300, batch=32, classes=21, lr=2e-3)


def _on_card(card, msg):
    log("  [%s] %s" % (card, msg))


def _kernel_run(torch, dev, op_type, ins, attrs, lods=None, keep=(),
                outs=(), wrt=(), out=None, dtype=None):
    """One op kernel called through the port's registry on `dev`:
    ({slot: numpy}, [numpy gradients of `out` towards the `wrt` slots]).
    `lods` maps an input slot to its offsets (fed with their host copy),
    `outs` names output slots whose side-bands to return
    ("<slot>@LOD0"), `keep` the outputs that count as read; `dtype`
    casts float inputs (bfloat16 for the AMP check)."""
    import types

    from paddle_tpu_torch.fluid.core.registry import LoweringContext, \
        get_kernel
    from paddle_tpu_torch.utils import prng

    dev = torch.device(dev)
    op = types.SimpleNamespace(
        type=op_type, inputs={s: [s] for s in ins},
        outputs={s: [s] for s in set(outs) | set(keep) | (
            {out} if out else set())})
    ctx = LoweringContext(None, prng.PRNGKey(0), dev)
    ctx.op, ctx.keep, ctx.env = op, tuple(keep) + ((out,) if out else ()), {}
    for slot, off in (lods or {}).items():
        host = np.asarray(off, np.int32)
        ctx.set_lod(slot, torch.from_numpy(host.copy()).to(dev), host)
    tins = {}
    for slot, arrays in ins.items():
        vals = []
        for a in arrays:
            t = torch.from_numpy(np.array(a)).to(dev)
            if dtype is not None and t.is_floating_point():
                t = t.to(dtype)
            if slot in wrt:
                t.requires_grad_(True)
            vals.append(t)
        tins[slot] = vals
    with torch.enable_grad():
        res = get_kernel(op_type)(ctx, tins, dict(attrs))
    grads = []
    if wrt:
        y = res[out]
        cot = torch.from_numpy(np.random.RandomState(0).randn(
            *y.shape).astype(np.float32)).to(dev, y.dtype)
        grads = [g.float().cpu().numpy() for g in torch.autograd.grad(
            y, [tins[s][0] for s in wrt], cot)]
    got = {k: (v[0] if isinstance(v, (list, tuple)) else v)
           for k, v in res.items()}
    got = {k: v.detach().float().cpu().numpy() if v.is_floating_point()
           else v.detach().cpu().numpy() for k, v in got.items()}
    for slot in outs:
        key = slot + "@LOD0"
        if key in ctx.env:
            got[key] = ctx.env[key].cpu().numpy()
    return got, grads


def _boxes(rng, n, lo=0.05, hi=0.3):
    centers = rng.rand(n, 2).astype(np.float32)
    sizes = lo + (hi - lo) * rng.rand(n, 2).astype(np.float32)
    return np.concatenate([centers - sizes / 2, centers + sizes / 2],
                          axis=1).astype(np.float32)


def _offsets(lens):
    return np.cumsum([0] + list(lens)).astype(np.int32)


def new_op_cases(rng):
    """(name, op, ins, attrs, lods, exact slots, float slots, outs, wrt,
    out) of phase 28: every op this slice ports, at a few hundred to a
    few million elements."""
    cases = []

    def add(name, op, ins, attrs, lods=None, exact=(), floats=(), outs=(),
            wrt=(), out=None):
        cases.append((name, op, ins, attrs, lods or {}, exact, floats,
                      outs, wrt, out))

    x = rng.randn(8, 64, 28, 28).astype(np.float32)
    add("lrn", "lrn", {"X": [x]}, dict(n=5, k=1.0, alpha=1e-4, beta=0.75),
        floats=("Out", "MidOut"), wrt=("X",), out="Out")
    lens = [1, 17, 40, 8, 1, 60, 25, 33, 12, 5]
    total = sum(lens)
    n = SRL["labels"]
    crf = {"Emission": [rng.randn(total, n).astype(np.float32)],
           "Transition": [0.5 * rng.randn(n + 2, n).astype(np.float32)],
           "Label": [rng.randint(0, n, (total, 1)).astype(np.int64)]}
    add("linear_chain_crf", "linear_chain_crf", crf, {},
        {"Emission": _offsets(lens)},
        floats=("LogLikelihood", "Alpha", "EmissionExps", "TransitionExps"),
        outs=("Alpha", "EmissionExps", "TransitionExps"),
        wrt=("Emission", "Transition"), out="LogLikelihood")
    add("crf_decoding", "crf_decoding",
        {"Emission": crf["Emission"], "Transition": crf["Transition"]}, {},
        {"Emission": _offsets(lens)}, exact=("ViterbiPath",))
    tied = {"Emission": [rng.randint(0, 2, (total, 4)).astype(np.float32)],
            "Transition": [rng.randint(0, 2, (6, 4)).astype(np.float32)]}
    add("crf_decoding (ties)", "crf_decoding", tied, {},
        {"Emission": _offsets(lens)}, exact=("ViterbiPath",))
    label = rng.randint(0, n, total)
    infer = np.where(rng.rand(total) < 0.7, label, rng.randint(0, n, total))
    for scheme, types_, excl in (("IOB", 29, []), ("IOE", 29, [3]),
                                 ("IOBES", 14, []), ("plain", 58, [0])):
        add("chunk_eval %s" % scheme, "chunk_eval",
            {"Inference": [infer.reshape(-1, 1).astype(np.int64)],
             "Label": [label.reshape(-1, 1).astype(np.int64)]},
            dict(chunk_scheme=scheme, num_chunk_types=types_,
                 excluded_chunk_types=excl), {"Label": _offsets(lens)},
            exact=("NumInferChunks", "NumLabelChunks", "NumCorrectChunks"),
            floats=("Precision", "Recall", "F1-Score"))
    C = 10
    add("precision_recall", "precision_recall",
        {"Indices": [rng.randint(0, C, (4096, 1)).astype(np.int64)],
         "Labels": [rng.randint(0, C, (4096, 1)).astype(np.int64)],
         "Weights": [rng.rand(4096, 1).astype(np.float32)],
         "StatesInfo": [rng.randint(0, 50, (C, 4)).astype(np.float32)]},
        dict(class_number=C),
        floats=("BatchMetrics", "AccumMetrics", "AccumStatesInfo"))
    add("prior_box", "prior_box",
        {"Input": [rng.rand(2, 16, 75, 75).astype(np.float32)],
         "Image": [rng.rand(2, 3, 300, 300).astype(np.float32)]},
        dict(min_sizes=[60.0], max_sizes=[111.0], aspect_ratios=[2.0, 3.0],
             flip=True, clip=True), floats=("Boxes", "Variances"))
    M = 2000
    priors = _boxes(rng, M, 0.05, 0.5)
    pvar = np.tile(np.float32([0.1, 0.1, 0.2, 0.2]), (M, 1))
    add("box_coder encode", "box_coder",
        {"PriorBox": [priors], "PriorBoxVar": [pvar],
         "TargetBox": [_boxes(rng, M, 0.05, 0.5)]},
        dict(code_type="encode_center_size"), floats=("OutputBox",))
    add("box_coder decode", "box_coder",
        {"PriorBox": [priors], "PriorBoxVar": [pvar],
         "TargetBox": [0.5 * rng.randn(4, M, 4).astype(np.float32)]},
        dict(code_type="decode_center_size"), floats=("OutputBox",))
    add("bipartite_match", "bipartite_match",
        {"DistMat": [rng.rand(12, 300).astype(np.float32)]}, {},
        exact=("ColToRowMatchIndices",), floats=("ColToRowMatchDist",))
    Cn = 21
    boxes = _boxes(rng, M, 0.05, 0.3)
    add("multiclass_nms", "multiclass_nms",
        {"Scores": [rng.rand(4, Cn, M).astype(np.float32) ** 4],
         "BBoxes": [np.stack([boxes] * 4)]},
        dict(background_label=0, score_threshold=0.1, nms_top_k=400,
             nms_threshold=0.45, keep_top_k=200), exact=("Out@LOD0",),
        floats=("Out",), outs=("Out",))
    add("roi_pool", "roi_pool",
        {"X": [rng.randn(4, 32, 38, 38).astype(np.float32)],
         "ROIs": [np.concatenate([rng.randint(0, 30, (64, 2)),
                                  rng.randint(40, 76, (64, 2))],
                                 1)[:, [0, 1, 2, 3]].astype(np.float32)]},
        dict(pooled_height=7, pooled_width=7, spatial_scale=0.5),
        {"ROIs": _offsets([16, 16, 16, 16])}, floats=("Out",),
        outs=("Out",), wrt=("X",), out="Out")
    gts = [2, 0, 3, 1, 4, 1, 1, 2]
    P, Ccls = 1000, 21
    add("ssd_multibox_loss", "ssd_multibox_loss",
        {"Loc": [0.5 * rng.randn(len(gts), P, 4).astype(np.float32)],
         "Conf": [rng.randn(len(gts), P, Ccls).astype(np.float32)],
         "GTBox": [_boxes(rng, sum(gts), 0.2, 0.5)],
         "GTLabel": [rng.randint(1, Ccls, (sum(gts), 1)).astype(np.int64)],
         "PriorBox": [_boxes(rng, P, 0.1, 0.5)],
         "PriorVar": [np.tile(np.float32([0.1, 0.1, 0.2, 0.2]), (P, 1))]},
        dict(overlap_threshold=0.5, neg_pos_ratio=3.0, neg_overlap=0.5,
             background_id=0), {"GTBox": _offsets(gts)}, floats=("Out",),
        wrt=("Loc", "Conf"), out="Out")
    glens, K = [3, 1, 2, 4], 50
    gt = _boxes(rng, sum(glens), 0.2, 0.4)
    glab = rng.randint(1, 5, (sum(glens), 1))
    det = np.full((len(glens) * K, 6), -1.0, np.float32)
    lod = _offsets(glens)
    for i in range(len(glens)):
        for k in range(40):
            g = lod[i] + k % glens[i]
            own = k < 2 * glens[i]
            det[i * K + k] = [glab[g, 0] if own else rng.randint(0, 5),
                              rng.rand(), *(gt[g] + 0.02 * rng.randn(4)
                                            if own else _boxes(rng, 1)[0])]
    add("detection_map", "detection_map",
        {"Detection": [det], "GTBox": [gt], "GTLabel": [glab],
         "GTDifficult": [(rng.rand(sum(glens), 1) < 0.2).astype(
             np.float32)]},
        dict(overlap_threshold=0.5, num_classes=5, pad_stride=K,
             background_id=0), {"GTBox": lod}, floats=("MAP",))
    add("pnpair_eval", "pnpair_eval",
        {"Score": [np.round(rng.rand(2000, 1) * 20).astype(np.float32)],
         "Label": [rng.randint(0, 3, (2000, 1)).astype(np.float32)],
         "QueryID": [rng.randint(0, 40, (2000, 1)).astype(np.int64)],
         "Weight": [rng.rand(2000, 1).astype(np.float32)]}, {},
        floats=("Out",))
    return cases


def _rel_err(a, b):
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)) \
        if a.size else 0.0


def schedule_program(fluid, kind, on):
    """A regression trained by SGD at one of the five schedules' rates,
    on a force_cpu global step the optimizer advances (the book's SRL
    pattern, tests/test_label_semantic_roles.py:158-170)."""
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        x = fluid.layers.data(name="x", shape=[16], dtype="float32")
        y = fluid.layers.data(name="y", shape=[1], dtype="float32")
        loss = fluid.layers.mean(x=fluid.layers.square_error_cost(
            input=fluid.layers.fc(input=x, size=1), label=y))
        gs = fluid.layers.create_global_var(
            shape=[1], value=0, dtype="float32", force_cpu=True,
            persistable=True)
        d = fluid.learning_rate_decay
        lr = {
            "exponential": lambda: d.exponential_decay(0.1, gs, 2, 0.5, on),
            "natural_exp": lambda: d.natural_exp_decay(0.1, gs, 2, 0.5, on),
            "inverse_time": lambda: d.inverse_time_decay(0.1, gs, 2, 0.5,
                                                         on),
            "polynomial": lambda: d.polynomial_decay(0.1, gs, 3, 0.01, 2.0,
                                                     cycle=on),
            "piecewise": lambda: d.piecewise_decay(gs, [1.5, 3],
                                                   [0.1, 0.05, 0.01]),
        }[kind]()
        fluid.optimizer.SGD(learning_rate=lr, global_step=gs).minimize(loss)
    return main, startup, [loss, lr, gs]


def phase_new_op_parity(torch, fluid, place=None, card="cpu"):
    """Phase 28: every op this slice ports on the card against the same
    kernel on the CPU on the same seeded inputs: lrn (f32, and bf16 as
    under AMP), the four CRF ops, the eight detection ops, with the
    gradients of lrn, linear_chain_crf, roi_pool and ssd_multibox_loss;
    the five learning-rate schedules over 5 SGD steps; the Accuracy,
    ChunkEvaluator and DetectionMAP evaluators. f32 within 1e-5 (relative
    to each output's largest magnitude), integers and chunk counts
    equal, bf16 within 2e-2."""
    dev = "cuda" if place is None else fluid.Executor(place).device.type
    rng = np.random.RandomState(28)
    results = {}
    for (name, op, ins, attrs, lods, exact, floats, outs, wrt,
         out) in new_op_cases(rng):
        slots = tuple(s.split("@")[0] for s in exact + floats)
        kw = dict(lods=lods, keep=slots, outs=outs, wrt=wrt, out=out)
        c, cg = _kernel_run(torch, dev, op, ins, attrs, **kw)
        h, hg = _kernel_run(torch, "cpu", op, ins, attrs, **kw)
        same = all(np.array_equal(c[s], h[s]) for s in exact)
        errs = [_rel_err(c[s], h[s]) for s in floats] + \
            [_rel_err(a, b) for a, b in zip(cg, hg)]
        err = max(errs) if errs else 0.0
        ok = same and err <= 1e-5
        _on_card(card, "%s: %smax rel diff card vs CPU %.3e (outputs%s) "
                 "%s" % (name, "%s equal, " % ", ".join(exact) if exact
                         else "", err, " and gradients towards %s"
                         % ", ".join(wrt) if wrt else "",
                         "ok" if ok else "FAIL"))
        check(ok, "phase 28: %s differs on the card" % name)
        results[name] = dict(rel_err=err, exact=same)
    # lrn under AMP: bf16 in, bf16 out, the window sum in f32
    x = rng.randn(8, 64, 28, 28).astype(np.float32)
    kw = dict(keep=("Out", "MidOut"), wrt=("X",), out="Out",
              dtype=torch.bfloat16)
    attrs = dict(n=5, k=1.0, alpha=1e-4, beta=0.75)
    c, cg = _kernel_run(torch, dev, "lrn", {"X": [x]}, attrs, **kw)
    h, hg = _kernel_run(torch, "cpu", "lrn", {"X": [x]}, attrs, **kw)
    err = max(_rel_err(c["Out"], h["Out"]), _rel_err(cg[0], hg[0]))
    mid = _rel_err(c["MidOut"], h["MidOut"])
    ok = err <= 2e-2 and mid <= 1e-5
    _on_card(card, "lrn bf16 (AMP): Out and grad max rel diff %.3e, MidOut "
             "(f32) %.3e %s" % (err, mid, "ok" if ok else "FAIL"))
    check(ok, "phase 28: bf16 lrn differs on the card")
    results["lrn bf16"] = dict(rel_err=err, midout_rel_err=mid)

    feed_rng = np.random.RandomState(29)
    feed = dict(x=feed_rng.randn(32, 16).astype(np.float32),
                y=feed_rng.randn(32, 1).astype(np.float32))
    for kind in ("exponential", "natural_exp", "inverse_time",
                 "polynomial", "piecewise"):
        for on in ((False, True) if kind != "piecewise" else (False,)):
            main, startup, fetch = schedule_program(fluid, kind, on)

            def run(exe):
                return [exe.run(main, feed=feed, fetch_list=fetch)
                        for _ in range(5)]

            runs, _ = _card_and_cpu(fluid, startup, run, place)
            (c, _), (h, _) = runs["card"], runs["cpu"]
            rate = max(_rel_err(a[1], b[1]) for a, b in zip(c, h))
            loss = max(_rel_err(a[0], b[0]) for a, b in zip(c, h))
            steps = [float(a[2][0]) for a in c]
            ok = rate <= 1e-6 and loss <= 1e-5 and steps == [1, 2, 3, 4, 5]
            label = "%s%s" % (kind, " (staircase)" if on and kind !=
                              "polynomial" else " (cycle)" if on else "")
            _on_card(card, "schedule %s: rates %s, max rel diff rate %.3e, "
                     "loss %.3e, global step %s %s" % (
                         label, ["%.6f" % float(a[1][0]) for a in c], rate,
                         loss, steps, "ok" if ok else "FAIL"))
            check(ok, "phase 28: the %s schedule differs" % label)
            results["schedule " + label] = dict(rate_rel_err=rate)

    # Accuracy and ChunkEvaluator through the executor, DetectionMAP on
    # the host over each device's multiclass_nms rows
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        xv = fluid.layers.data(name="x", shape=[16], dtype="float32")
        lbl = fluid.layers.data(name="lbl", shape=[1], dtype="int64")
        inf = fluid.layers.data(name="inf", shape=[1], dtype="int64",
                                lod_level=1)
        lab = fluid.layers.data(name="lab", shape=[1], dtype="int64",
                                lod_level=1)
        acc = fluid.evaluator.Accuracy(
            input=fluid.layers.fc(input=xv, size=10, act="softmax"),
            label=lbl)
        chunk = fluid.evaluator.ChunkEvaluator(
            input=inf, label=lab, chunk_scheme="IOB", num_chunk_types=29)

    def batches(seed):
        r = np.random.RandomState(seed)
        lens = r.randint(1, 60, 10)
        label = r.randint(0, 59, int(lens.sum()))
        infer = np.where(r.rand(label.size) < 0.6, label,
                         r.randint(0, 59, label.size))
        lod = [_offsets(lens)]
        return dict(x=r.randn(64, 16).astype(np.float32),
                    lbl=r.randint(0, 10, (64, 1)).astype(np.int64),
                    inf=(infer.reshape(-1, 1).astype(np.int64), lod),
                    lab=(label.reshape(-1, 1).astype(np.int64), lod))

    def evaluate(exe):
        acc.reset(exe)
        chunk.reset(exe)
        for s in range(3):
            exe.run(main, feed=batches(s), fetch_list=acc.metrics)
        return float(acc.eval(exe)), chunk.eval(exe)

    runs, _ = _card_and_cpu(fluid, startup, evaluate, place)
    (ca, cc), (ha, hc) = runs["card"][0], runs["cpu"][0]
    ok = ca == ha and np.array_equal(cc, hc) and cc[0] > 0
    _on_card(card, "Accuracy %.6f vs CPU %.6f; ChunkEvaluator P/R/F1 %s vs "
             "CPU %s %s" % (ca, ha, cc.tolist(), hc.tolist(),
                            "ok" if ok else "FAIL"))
    check(ok, "phase 28: an evaluator differs on the card")
    nms = [c for c in new_op_cases(np.random.RandomState(28))
           if c[0] == "multiclass_nms"][0]
    maps = []
    for d in (dev, "cpu"):
        got, _ = _kernel_run(torch, d, "multiclass_nms", nms[2], nms[3],
                             outs=("Out",), keep=("Out",))
        rows = got["Out"].reshape(4, -1, 6)
        boxes, scores = nms[2]["BBoxes"][0], nms[2]["Scores"][0]
        ev = fluid.evaluator.DetectionMAP(overlap_threshold=0.5)
        # ground truth: each image's best-scored box of classes 1..3
        ev.update([r[r[:, 0] >= 0] for r in rows],
                  [boxes[i][scores[i, 1:4].argmax(1)] for i in range(4)],
                  [np.array([1, 2, 3]) for _ in range(4)])
        maps.append(ev.eval())
    ok = abs(maps[0] - maps[1]) <= 1e-6 and maps[0] > 0
    _on_card(card, "DetectionMAP over the card's NMS rows %.6f vs the CPU's "
             "%.6f %s" % (maps[0], maps[1], "ok" if ok else "FAIL"))
    check(ok, "phase 28: DetectionMAP differs on the card")
    results["evaluators"] = dict(accuracy=ca, chunk=cc.tolist(),
                                 detection_map=maps[0])
    return results


def book_image_program(fluid, model, cfg, opt):
    """(main, startup, loss, accuracy evaluator) of the book's
    recognize_digits / image_classification: model -> cross_entropy ->
    mean, an Accuracy evaluator, `opt` minimising the loss."""
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        image = fluid.layers.data(name="image", shape=cfg["shape"],
                                  dtype="float32")
        label = fluid.layers.data(name="label", shape=[1], dtype="int64")
        predict = model(image, cfg["classes"])
        avg = fluid.layers.mean(
            x=fluid.layers.cross_entropy(input=predict, label=label))
        acc = fluid.evaluator.Accuracy(input=predict, label=label)
        opt(fluid).minimize(avg)
    return main, startup, avg, acc


def book_image_feed(torch, cfg, batch, dev, seed=0):
    """A seeded synthetic batch, zero-mean as the books normalise their
    images: labels in [0, classes), each image its class's fixed random
    template plus as much noise."""
    rng = np.random.RandomState(seed)
    templates = np.random.RandomState(1234).randn(cfg["classes"],
                                                  *cfg["shape"])
    label = rng.randint(0, cfg["classes"], (batch, 1)).astype(np.int64)
    image = (templates[label[:, 0]] + rng.randn(batch, *cfg["shape"])
             ).astype(np.float32) / np.float32(np.sqrt(2.0))
    return {"image": torch.from_numpy(image).to(dev),
            "label": torch.from_numpy(label).to(dev)}


def _timed_steps(torch, step, dev, warm, steps):
    """(results of warm + steps calls, warm-up s, timed wall s, peak
    bytes the timed steps reached)."""
    t0 = time.monotonic()
    outs = [step() for _ in range(warm)]
    _sync(torch, dev.type)
    warm_s = time.monotonic() - t0
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    outs += [step() for _ in range(steps)]
    _sync(torch, dev.type)
    wall = time.monotonic() - t0
    peak = torch.cuda.max_memory_allocated() if dev.type == "cuda" else 0
    return outs, warm_s, wall, peak


def phase_book_images(torch, fluid, lenet, vgg, warm=2, steps=10, total=30,
                      place=None, cfgs=BOOK_IMAGE, card="cpu"):
    """Phase 29: the two BASELINE.json image configs, MNIST LeNet and
    VGG-16-bn-drop CIFAR-10, in f32 with the books' Adam(1e-3): 2 warm-up
    and 10 timed steps on one seeded batch ending in a sync (ms/step,
    img/s, peak memory), then to 30 steps (the loss must fall) with the
    Accuracy evaluator over the timed and later steps; then 3 Momentum
    (0.01, 0.9) steps at the config's parity batch (LeNet 8, VGG 32) on
    the card and on the CPU from one set of startup weights: losses
    within rtol 1e-4, parameters and
    batch-norm statistics within atol 1e-4 (Momentum, not Adam: Adam
    steps every noise-level gradient, such as a conv bias before batch
    norm, by up to lr in either direction)."""
    models = {"lenet_mnist": lenet.lenet,
              "vgg16_bn_drop_cifar10": vgg.vgg16_bn_drop}
    out = {}
    for name, cfg in cfgs.items():
        adam = lambda f: f.optimizer.Adam(learning_rate=1e-3)  # noqa: E731
        main, startup, avg, acc = book_image_program(
            fluid, models[name], cfg, adam)
        scope = fluid.Scope()
        with fluid.scope_guard(scope):
            exe = fluid.Executor(place or fluid.CUDAPlace(0))
            dev = exe.device
            exe.run(startup)
            feed = book_image_feed(torch, cfg, cfg["batch"], dev)

            def step():
                return exe.run(main, feed=feed, fetch_list=[avg],
                               return_numpy=False)[0]

            acc.reset(exe)
            losses, warm_s, wall, peak = _timed_steps(torch, step, dev,
                                                      warm, steps)
            losses += [step() for _ in range(total - warm - steps)]
            losses = [float(x.reshape(())) for x in losses]
            accuracy = float(acc.eval(exe))
            ok = all(math.isfinite(x) for x in losses) and \
                np.mean(losses[-5:]) < np.mean(losses[:5])
            ips = cfg["batch"] * steps / wall
            _on_card(card, "%s: %d steps of batch %d, f32 Adam(1e-3): %.3f "
                     "ms/step, %.1f img/s, peak device memory %.3f GiB; "
                     "losses %.4f -> %.4f over %d steps; Accuracy "
                     "evaluator over them %.4f %s" % (
                         name, steps, cfg["batch"], wall / steps * 1e3, ips,
                         peak / 2 ** 30, losses[0], losses[-1], total,
                         accuracy, "ok" if ok else "FAIL"))
            check(ok, "%s: the loss did not fall: %s" % (name, losses))
            out[name] = dict(ms_per_step=wall / steps * 1e3, img_per_s=ips,
                             peak_mem_gib=peak / 2 ** 30, warm_s=warm_s,
                             losses=losses, accuracy=accuracy)
        del scope, exe, feed, step

        momentum = lambda f: f.optimizer.Momentum(  # noqa: E731
            learning_rate=0.01, momentum=0.9)
        main, startup, avg, _ = book_image_program(fluid, models[name], cfg,
                                                   momentum)

        def train(exe):
            feed = book_image_feed(torch, cfg, cfg["parity_batch"],
                                   exe.device, 1)
            return [float(exe.run(main, feed=feed, fetch_list=[avg])[0][0])
                    for _ in range(3)]

        # deterministic cuDNN algorithms: the card's side repeats run to
        # run (as phase 36's)
        torch.backends.cudnn.deterministic = True
        try:
            runs, init = _card_and_cpu(fluid, startup, train, place)
        finally:
            torch.backends.cudnn.deterministic = False
        (lc, sc), (lh, sh) = runs["card"], runs["cpu"]
        block = main.global_block()
        state = {p.name for p in block.all_parameters()}
        for op in block.ops:
            if op.type == "batch_norm":
                state |= set(op.input("Mean") + op.input("Variance"))
        loss_err = max(abs(a - b) / abs(b) for a, b in zip(lc, lh))
        p_err = max(float(np.abs(sc[n] - sh[n]).max()) for n in state)
        moved = max(float(np.abs(sh[n] - init[n]).max()) for n in state)
        ok = loss_err <= 1e-4 and p_err <= 1e-4
        _on_card(card, "%s f32 card vs CPU, 3 Momentum steps at batch %d: "
                 "max rel loss diff %.3e, max param/statistic diff %.3e "
                 "(moved up to %.3e) %s" % (name, cfg["parity_batch"],
                                            loss_err,
                                            p_err, moved,
                                            "ok" if ok else "FAIL"))
        check(ok, "%s: f32 training on the card diverged from the CPU"
              % name)
        out[name].update(loss_rel_err=loss_err, param_abs_err=p_err)
        if torch.cuda.is_available():
            torch.cuda.empty_cache()
    return out


def phase_image_zoo(torch, fluid, zoo, profile=False, warm=2, steps=5,
                    place=None, shape=(3, 224, 224), cells=ZOO_CELLS,
                    card="cpu"):
    """Phase 30: bench.py's ImageNet zoo cells (bench.py:4437-4445,
    _build_image_workload): AlexNet 128, GoogLeNet 128, VGG-16 64 and
    MobileNet-v1 128 images of [3, 224, 224], 1000 classes,
    Momentum(0.01, 0.9), bf16 AMP; 2 warm-up and 5 timed steps on one
    batch ending in a sync (ms/step, img/s, bench.py's FLOP share of 989
    TFLOP/s, peak memory) beside the reference's own K40m img/s where
    bench.py names one; GoogLeNet's lrn ops counted over one step. With
    --profile, 2 profiled steps of each (GoogLeNet's with lrn's forward
    device time as its own range)."""
    from paddle_tpu_torch.fluid.profiler import OpCounter

    out = {}
    torch.backends.cudnn.benchmark = True
    try:
        for name, (batch, k40m) in cells.items():
            main, startup, avg = fluid_image_program(
                fluid, zoo[name], list(shape), 1000, amp=True)
            scope = fluid.Scope()
            with fluid.scope_guard(scope):
                exe = fluid.Executor(place or fluid.CUDAPlace(0))
                dev = exe.device
                exe.run(startup)
                feed = image_feed(torch, batch, list(shape), 1000, dev)

                def step():
                    return exe.run(main, feed=feed, fetch_list=[avg],
                                   return_numpy=False)[0]

                losses, warm_s, wall, peak = _timed_steps(torch, step, dev,
                                                          warm, steps)
                losses = [float(x.reshape(())) for x in losses]
                ok = all(math.isfinite(x) for x in losses)
                ips = batch * steps / wall
                share = ips * 3 * ZOO_FWD_FLOPS[name] / PEAK_FLOPS["bfloat16"]
                with OpCounter(["lrn"]) as counted:
                    step()
                _on_card(card, "%s: %d steps of batch %d, bf16 AMP: %.3f "
                         "ms/step, %.1f img/s, FLOP share %.4f of 989 "
                         "TFLOP/s (bench.py's count), peak %.2f GiB, warm-up "
                         "%.1f s; lrn ops per step %d; losses %s%s %s" % (
                             name, steps, batch, wall / steps * 1e3, ips,
                             share, peak / 2 ** 30, warm_s,
                             counted.counts["lrn"],
                             ", ".join("%.4f" % x for x in losses),
                             "; the reference's own K40m figure %.1f img/s "
                             "(bench.py:4433-4440, context only)" % k40m
                             if k40m else "", "ok" if ok else "FAIL"))
                check(ok, "%s: a loss is not finite: %s" % (name, losses))
                if name == "googlenet":
                    check(counted.counts["lrn"] == 2, "GoogLeNet ran %d lrn "
                          "ops in a step" % counted.counts["lrn"])
                out[name] = dict(batch=batch, ms_per_step=wall / steps * 1e3,
                                 img_per_s=ips, flop_share=share,
                                 peak_mem_gib=peak / 2 ** 30, warm_s=warm_s,
                                 losses=losses,
                                 lrn_ops_per_step=counted.counts["lrn"],
                                 reference_k40m_img_per_s=k40m)
                if profile:
                    with OpCounter(["lrn"], ranges=True):
                        out[name]["profile"] = profile_fluid(
                            torch, step, 2, "2 %s steps" % name,
                            extra_regions=("fluid/op/lrn",)
                            if counted.counts["lrn"] else ())
            del scope, exe, feed, step
            if torch.cuda.is_available():
                torch.cuda.empty_cache()
    finally:
        torch.backends.cudnn.benchmark = False
    return out


def srl_program(fluid, cfg):
    """The book's label_semantic_roles (tests/test_label_semantic_roles.py:
    31-200: db_lstm over 8 slots, linear_chain_crf with the transitions'
    per-parameter learning rate, exponential_decay on a force_cpu global
    step, SGD, crf_decoding, ChunkEvaluator) at `cfg`'s widths.
    Returns (main, startup, avg_cost, crf_decode, chunk evaluator,
    global step, learning rate)."""
    pd = fluid.layers
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        slots = [pd.data(name=n, shape=[1], dtype="int64", lod_level=1)
                 for n in ("word", "verb", "ctx_n2", "ctx_n1", "ctx_0",
                           "ctx_p1", "ctx_p2", "mark")]
        word_slots, predicate, mark = slots[:1] + slots[2:7], slots[1], \
            slots[7]
        embs = [pd.embedding(input=x, size=[cfg["word_dict"],
                                            cfg["word_dim"]],
                             param_attr=fluid.ParamAttr(name="emb",
                                                        trainable=False))
                for x in word_slots]
        embs.append(pd.embedding(input=predicate, size=[cfg["pred_dict"],
                                                        cfg["word_dim"]],
                                 param_attr="vemb"))
        embs.append(pd.embedding(input=mark, size=[cfg["mark_dict"],
                                                   cfg["mark_dim"]]))
        H = cfg["hidden"]
        hidden_0 = pd.sums(input=[pd.fc(input=e, size=H) for e in embs])
        lstm_0 = pd.dynamic_lstm(input=hidden_0, size=H,
                                 candidate_activation="relu",
                                 gate_activation="sigmoid",
                                 cell_activation="sigmoid")[0]
        input_tmp = [hidden_0, lstm_0]
        for i in range(1, cfg["depth"]):
            mix = pd.sums(input=[pd.fc(input=input_tmp[0], size=H),
                                 pd.fc(input=input_tmp[1], size=H)])
            lstm = pd.dynamic_lstm(input=mix, size=H,
                                   candidate_activation="relu",
                                   gate_activation="sigmoid",
                                   cell_activation="sigmoid",
                                   is_reverse=(i % 2) == 1)[0]
            input_tmp = [mix, lstm]
        feature_out = pd.sums(input=[
            pd.fc(input=input_tmp[0], size=cfg["labels"]),
            pd.fc(input=input_tmp[1], size=cfg["labels"])])
        target = pd.data(name="target", shape=[1], dtype="int64",
                         lod_level=1)
        crf_cost = pd.linear_chain_crf(
            input=feature_out, label=target,
            param_attr=fluid.ParamAttr(name="crfw",
                                       learning_rate=cfg["crf_lr"]))
        avg_cost = pd.mean(x=crf_cost)
        global_step = pd.create_global_var(
            shape=[1], value=0, dtype="float32", force_cpu=True,
            persistable=True)
        lr = fluid.learning_rate_decay.exponential_decay(
            learning_rate=cfg["lr"], global_step=global_step,
            decay_steps=100000, decay_rate=0.5, staircase=True)
        fluid.optimizer.SGD(learning_rate=lr,
                            global_step=global_step).minimize(avg_cost)
        crf_decode = pd.crf_decoding(input=feature_out,
                                     param_attr=fluid.ParamAttr(name="crfw"))
        chunk = fluid.evaluator.ChunkEvaluator(
            input=crf_decode, label=target, chunk_scheme="IOB",
            num_chunk_types=(cfg["labels"] - 1) // 2)
    return main, startup, avg_cost, crf_decode, chunk, global_step, lr


def srl_feed(torch, cfg, dev, seed=0):
    """Seeded sentences of lo..hi tokens with tests/test_label_semantic_
    roles.py's derivable labels, scaled to conll05's dictionaries: a
    marked predicate is B of chunk type 1, a low word id (the first third
    of the dictionary) B of chunk type 0, another word id divisible by 7
    B of chunk type (id mod 29), the rest O (the last label). Returns
    (feed, tokens)."""
    rng = np.random.RandomState(seed)
    lens = ragged_lengths(rng, cfg["batch"], cfg["lo"], cfg["hi"],
                          one=False)
    cols = {k: [] for k in ("word", "verb", "ctx_n2", "ctx_n1", "ctx_0",
                            "ctx_p1", "ctx_p2", "mark", "target")}
    outside = cfg["labels"] - 1
    for ln in lens:
        words = rng.randint(2, cfg["word_dict"], ln)
        pred_pos = rng.randint(0, ln)
        mark = (np.arange(ln) == pred_pos).astype(np.int64)
        labels = np.full(ln, outside)
        labels[words < cfg["word_dict"] // 3] = 0
        labels[mark == 1] = 2
        typ = words % ((cfg["labels"] - 1) // 2)
        labels[(words % 7 == 0) & (labels == outside)] = 2 * typ[
            (words % 7 == 0) & (labels == outside)]
        cols["word"].append(words)
        cols["verb"].append(np.full(ln, rng.randint(0, cfg["pred_dict"])))
        for k, s in (("ctx_n2", 2), ("ctx_n1", 1), ("ctx_0", 0),
                     ("ctx_p1", -1), ("ctx_p2", -2)):
            cols[k].append(np.roll(words, s))
        cols["mark"].append(mark)
        cols["target"].append(labels)
    lod = [_offsets(lens)]
    feed = {k: (torch.from_numpy(np.concatenate(v).reshape(-1, 1)
                                 .astype(np.int64)).to(dev), lod)
            for k, v in cols.items()}
    return feed, int(lens.sum())


def phase_srl(torch, fluid, profile=False, warm=2, steps=10, total=30,
              place=None, cfg=SRL, card="cpu"):
    """Phase 31: the book's SRL at its published widths (word_dim 32,
    mark_dim 5, hidden 512, depth 8) over conll05's dictionaries, batch
    10 synthetic sentences of 10-60 tokens, SGD at exponential_decay
    (base 5e-4, SRL's note) on a force_cpu global step, crfw at 1e-3 of
    it: 2 warm-up and 10 timed
    steps on one batch ending in a sync (ms/step, tokens/s), then to 30
    steps (the loss must fall), with crf_decoding and the ChunkEvaluator
    over those steps; one more step under
    torch.cuda.set_sync_debug_mode("error"), with the global step and
    the learning rate on the card."""
    main, startup, avg, decode, chunk, gstep, lr = srl_program(fluid, cfg)
    scope = fluid.Scope()
    out = {}
    with fluid.scope_guard(scope):
        exe = fluid.Executor(place or fluid.CUDAPlace(0))
        dev = exe.device
        exe.run(startup)
        feed, tokens = srl_feed(torch, cfg, dev)

        def step():
            return exe.run(main, feed=feed, fetch_list=[avg, decode, lr],
                           return_numpy=False)

        chunk.reset(exe)
        runs, warm_s, wall, peak = _timed_steps(torch, step, dev, warm,
                                                steps)
        runs += [step() for _ in range(total - warm - steps)]
        losses = [float(r[0].reshape(())) for r in runs]
        path = fluid.as_numpy(runs[-1][1])
        p, r, f1 = (float(v) for v in chunk.eval(exe))
        rate = runs[-1][2]
        ok = all(math.isfinite(x) for x in losses) and \
            np.mean(losses[-5:]) < np.mean(losses[:5]) and \
            path.shape == (tokens, 1) and \
            bool(((path >= 0) & (path < cfg["labels"])).all()) and \
            rate.device.type == dev.type and \
            scope.get(gstep.name).device.type == dev.type and \
            int(fluid.as_numpy(scope.get(gstep.name))[0]) == total
        _on_card(card, "SRL (hidden %d, depth %d, %d labels): %d steps of %d "
                 "sentences (%d tokens): %.3f ms/step, %.1f tokens/s, peak "
                 "%.3f GiB; losses %.4f -> %.4f over %d steps; crf_decoding "
                 "path %s; ChunkEvaluator over the steps P %.4f R %.4f F1 "
                 "%.4f; global step %d, learning rate %.6f on %s %s" % (
                     cfg["hidden"], cfg["depth"], cfg["labels"], steps,
                     cfg["batch"], tokens, wall / steps * 1e3,
                     tokens * steps / wall, peak / 2 ** 30, losses[0],
                     losses[-1], total, list(path.shape), p, r, f1,
                     int(fluid.as_numpy(scope.get(gstep.name))[0]),
                     float(fluid.as_numpy(rate)[0]), rate.device,
                     "ok" if ok else "FAIL"))
        check(ok, "the SRL phase failed: losses %s" % losses)
        out = dict(ms_per_step=wall / steps * 1e3,
                   tokens_per_s=tokens * steps / wall, tokens=tokens,
                   peak_mem_gib=peak / 2 ** 30, warm_s=warm_s,
                   losses=losses, precision=p, recall=r, f1=f1)
        if dev.type == "cuda":
            _sync(torch, "cuda")
            torch.cuda.set_sync_debug_mode("error")
            try:
                last = step()
            finally:
                torch.cuda.set_sync_debug_mode(0)
            check(math.isfinite(float(last[0].reshape(()))),
                  "the SRL's sync-checked step gave a non-finite loss")
            _on_card(card, "SRL training step under set_sync_debug_mode("
                     "'error'): no host sync")
            out["no_host_sync"] = True
        if profile:
            out["profile"] = profile_fluid(torch, step, 3,
                                           "3 SRL training steps")
    del scope, exe, feed, step
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
    return out


def ssd_batch(rng, cfg):
    """tests/test_ssd_model.py's _sample scaled to cfg["size"]: one
    bright square of a class in 1..classes-1 on noise per image, side
    S/4..S/2, its box in normalized corners."""
    S, n = cfg["size"], cfg["batch"]
    imgs = 0.1 * rng.rand(n, 3, S, S).astype(np.float32)
    boxes, labels = [], []
    for i in range(n):
        cls = int(rng.randint(1, cfg["classes"]))
        size = int(rng.randint(S // 4, S // 2))
        x0, y0 = (int(rng.randint(0, S - size)) for _ in range(2))
        imgs[i, :, y0:y0 + size, x0:x0 + size] = 0.3 + 0.7 * cls / \
            cfg["classes"]
        boxes.append([x0 / S, y0 / S, (x0 + size) / S, (y0 + size) / S])
        labels.append(cls)
    return imgs, np.asarray(boxes, np.float32), \
        np.asarray(labels, np.int64).reshape(-1, 1)


def ssd_program(fluid, ssd, cfg):
    """(main, startup, for_test clone, avg_cost, detections) of
    models/ssd.ssd_detector with Adam(cfg lr)."""
    main, startup = fluid.Program(), fluid.Program()
    S, n = cfg["size"], cfg["batch"]
    with fluid.program_guard(main, startup):
        image = fluid.layers.data(name="image", shape=[3, S, S],
                                  dtype="float32")
        gt_box = fluid.layers.data(name="gt_box", shape=[4],
                                   dtype="float32", lod_level=1)
        gt_label = fluid.layers.data(name="gt_label", shape=[1],
                                     dtype="int64", lod_level=1)
        avg_cost, dets = ssd.ssd_detector(
            image, gt_box, gt_label, num_classes=cfg["classes"],
            image_size=S, batch=n)
        test = main.clone(for_test=True)
        fluid.optimizer.Adam(learning_rate=cfg["lr"]).minimize(avg_cost)
    return main, startup, test, avg_cost, dets


def phase_ssd(torch, fluid, ssd, profile=False, warm=2, steps=10, total=30,
              place=None, cfg=SSD, card="cpu"):
    """Phase 32: ssd_detector at VOC's shape ([32, 3, 300, 300], 21
    classes; 20,982 priors: 3 per location of the 75x75 stride-4 and
    the 37x37 stride-8 maps) on seeded single-object images, f32
    Adam(2e-3): 2 warm-up and 10 timed training steps on one batch ending
    in a sync (ms/step, img/s, peak memory), then to 30 steps (the loss
    must fall); one more step under set_sync_debug_mode("error"); the
    detection_output eval step through the for_test clone (ms, after a
    warm-up), its rows well formed and -1 padded, and the host
    DetectionMAP over them and over the training batch's detections."""
    main, startup, test, avg, dets = ssd_program(fluid, ssd, cfg)
    n = cfg["batch"]
    scope = fluid.Scope()
    out = {}
    with fluid.scope_guard(scope):
        exe = fluid.Executor(place or fluid.CUDAPlace(0))
        dev = exe.device
        exe.run(startup)
        imgs, boxes, labels = ssd_batch(np.random.RandomState(0), cfg)
        lod = [np.arange(n + 1, dtype=np.int32)]
        feed = {"image": torch.from_numpy(imgs).to(dev),
                "gt_box": (torch.from_numpy(boxes).to(dev), lod),
                "gt_label": (torch.from_numpy(labels).to(dev), lod)}

        def step():
            return exe.run(main, feed=feed, fetch_list=[avg],
                           return_numpy=False)[0]

        losses, warm_s, wall, peak = _timed_steps(torch, step, dev, warm,
                                                  steps)
        losses += [step() for _ in range(total - warm - steps)]
        losses = [float(x.reshape(())) for x in losses]
        ok = all(math.isfinite(x) for x in losses) and \
            np.mean(losses[-5:]) < np.mean(losses[:5])
        _on_card(card, "SSD [%d, 3, %d, %d], %d classes, f32 Adam(%g): %d "
                 "steps: %.3f ms/step, %.1f img/s, peak %.3f GiB, warm-up "
                 "%.1f s; losses %.4f -> %.4f over %d steps %s" % (
                     n, cfg["size"], cfg["size"], cfg["classes"], cfg["lr"],
                     steps, wall / steps * 1e3, n * steps / wall,
                     peak / 2 ** 30, warm_s, losses[0], losses[-1], total,
                     "ok" if ok else "FAIL"))
        check(ok, "the SSD loss did not fall: %s" % losses)
        out = dict(ms_per_step=wall / steps * 1e3, img_per_s=n * steps / wall,
                   peak_mem_gib=peak / 2 ** 30, warm_s=warm_s, losses=losses)
        if dev.type == "cuda":
            _sync(torch, "cuda")
            torch.cuda.set_sync_debug_mode("error")
            try:
                last = step()
            finally:
                torch.cuda.set_sync_debug_mode(0)
            check(math.isfinite(float(last.reshape(()))),
                  "the SSD's sync-checked step gave a non-finite loss")
            _on_card(card, "SSD training step under set_sync_debug_mode("
                     "'error'): no host sync")
            out["no_host_sync"] = True

        eimgs, eboxes, elabels = ssd_batch(np.random.RandomState(1), cfg)
        efeed = {"image": torch.from_numpy(eimgs).to(dev)}

        def evaluate():
            return exe.run(test, feed=efeed, fetch_list=[dets],
                           return_numpy=False)[0]

        evaluate()
        _sync(torch, dev.type)
        t0 = time.monotonic()
        got = fluid.as_numpy(evaluate())  # the fetch reads the rows back
        eval_ms = (time.monotonic() - t0) * 1e3
        stride = got.shape[0] // n
        rows = got.reshape(n, stride, 6)
        valid = rows[..., 0] >= 0
        # valid rows first per image, the rest -1 filler
        first = bool((np.sort(~valid, axis=1, kind="stable") == ~valid).all())
        well = got.shape == (n * 8, 6) and first and bool(
            (rows[~valid] == -1).all()) and bool(
            ((rows[valid][:, 0] >= 0) & (rows[valid][:, 0] < cfg["classes"])
             & (rows[valid][:, 1] >= 0) & (rows[valid][:, 1] <= 1)).all())
        def detection_map(dets, boxes, labels):
            rows = dets.reshape(n, -1, 6)
            ev = fluid.evaluator.DetectionMAP(overlap_threshold=0.5)
            ev.update([r[r[:, 0] >= 0] for r in rows],
                      [boxes[i:i + 1] for i in range(n)],
                      [labels[i:i + 1, 0] for i in range(n)])
            return ev.eval()

        m = detection_map(got, eboxes, elabels)
        seen = detection_map(fluid.as_numpy(exe.run(
            test, feed={"image": feed["image"]}, fetch_list=[dets],
            return_numpy=False)[0]), boxes, labels)
        _on_card(card, "SSD detection_output eval step (for_test clone, "
                 "prior_box + box_coder + multiclass_nms over %d priors): "
                 "%.3f ms; detections %s, %d valid rows, -1 padded: %s; "
                 "DetectionMAP %.4f on a held-out batch, %.4f on the "
                 "training batch %s" % (
                     3 * ((cfg["size"] // 4) ** 2
                          + (cfg["size"] // 8) ** 2), eval_ms,
                     list(got.shape), int(valid.sum()), well, m, seen,
                     "ok" if well else "FAIL"))
        check(well, "the SSD detections are malformed")
        out.update(eval_ms=eval_ms, valid_detections=int(valid.sum()),
                   detection_map=m, detection_map_training_batch=seen)
        if profile:
            out["profile"] = profile_fluid(torch, step, 3,
                                           "3 SSD training steps")
            out["eval_profile"] = profile_fluid(torch, evaluate, 1,
                                                "1 SSD eval step")
    del scope, exe, feed, step
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
    return out


def _tree_map(fn, x):
    if isinstance(x, dict):
        return {k: _tree_map(fn, v) for k, v in x.items()}
    if isinstance(x, list):
        return [_tree_map(fn, v) for v in x]
    return fn(x)


# ---------------------------------------------------------------------
# phases 33-37: the rest of single-device Fluid (the last 14 ops,
# memory_optimize, run_grad_accum, ModelAverage and StaticPruning, the
# verifier, the numerics guard, AsyncDeviceFeeder and the profiler)
# ---------------------------------------------------------------------

# ResNet-50 in f32 for the remat parameter parity (one step at batch 16)
REMAT_PARITY = dict(FLUID_RESNET, batch=16)
# ResNet-50 f32 at the headline batch for run_grad_accum (the JAX package
# refuses AMP there), 4 micro-batches of 32
ACCUM_RESNET = dict(FLUID_RESNET, micro_batches=4)
# bench.py:763's profiler_reconciliation configuration: ResNet-50, batch
# 32, bf16 AMP
PROFILE_RESNET = dict(FLUID_RESNET, batch=32)


def _unpool_case(rng):
    """A 2x2 / 2 max pool of an [2, 2, 8, 8] plane and its flat argmax
    indices (first maximum), as tests/test_op_numeric.py feeds unpool."""
    x = rng.randn(2, 2, 8, 8).astype(np.float32)
    w = x.reshape(2, 2, 4, 2, 4, 2).transpose(0, 1, 2, 4, 3, 5).reshape(
        2, 2, 4, 4, 4)
    arg = w.argmax(-1)
    oh, ow = np.meshgrid(np.arange(4), np.arange(4), indexing="ij")
    idx = ((oh * 2 + arg // 2) * 8 + (ow * 2 + arg % 2)).astype(np.int32)
    return w.max(-1), idx


def rest_op_cases(rng):
    """(name, op, ins, attrs, exact outputs, float outputs, wrt, out) for
    the ops of phase 33, at the shapes of tests/test_op_numeric.py."""
    def f(*shape):
        return rng.randn(*shape).astype(np.float32)

    conv = [], ["Output"], ["Input", "Filter"], "Output"
    unp_x, unp_idx = _unpool_case(rng)
    cases = [
        ("conv2d_transpose", "conv2d_transpose",
         {"Input": [f(2, 3, 4, 4)], "Filter": [f(3, 2, 3, 3)]}, {}) + conv,
        ("conv2d_transpose s2 p1", "conv2d_transpose",
         {"Input": [f(1, 3, 5, 5)], "Filter": [f(3, 2, 3, 3)]},
         dict(strides=[2, 2], paddings=[1, 1])) + conv,
        ("conv3d", "conv3d",
         {"Input": [f(1, 2, 4, 4, 4)], "Filter": [f(3, 2, 2, 2, 2)]},
         {}) + conv,
        ("conv3d s2 p1", "conv3d",
         {"Input": [f(1, 2, 5, 5, 5)], "Filter": [f(3, 2, 3, 3, 3)]},
         dict(strides=[2, 2, 2], paddings=[1, 1, 1])) + conv,
        ("conv3d_transpose s2 p1", "conv3d_transpose",
         {"Input": [f(1, 2, 3, 3, 3)], "Filter": [f(2, 3, 2, 2, 2)]},
         dict(strides=[2, 2, 2], paddings=[1, 1, 1])) + conv,
        ("pool3d avg", "pool3d", {"X": [f(1, 2, 4, 4, 4)]},
         dict(pooling_type="avg", ksize=[2, 2, 2], strides=[2, 2, 2]),
         [], ["Out"], ["X"], "Out"),
        ("pool3d max k3 s2 p1 ceil", "pool3d", {"X": [f(2, 2, 5, 5, 5)]},
         dict(pooling_type="max", ksize=[3, 3, 3], strides=[2, 2, 2],
              paddings=[1, 1, 1], ceil_mode=True),
         [], ["Out"], ["X"], "Out"),
        ("max_pool2d_with_index", "max_pool2d_with_index",
         {"X": [f(2, 2, 7, 7)]},
         dict(ksize=[3, 3], strides=[2, 2], paddings=[1, 1]),
         ["Mask"], ["Out"], ["X"], "Out"),
        ("max_pool3d_with_index", "max_pool3d_with_index",
         {"X": [f(1, 2, 5, 5, 5)]},
         dict(ksize=[2, 2, 2], strides=[2, 2, 2]),
         ["Mask"], ["Out"], ["X"], "Out"),
        ("unpool", "unpool", {"X": [unp_x], "Indices": [unp_idx]},
         dict(unpooling_type="max", ksize=[2, 2], strides=[2, 2]),
         [], ["Out"], ["X"], "Out"),
        ("spp max", "spp", {"X": [f(2, 3, 7, 7)]},
         dict(pyramid_height=3, pooling_type="max"), [], ["Out"], ["X"],
         "Out"),
        ("spp avg", "spp", {"X": [f(2, 3, 6, 6)]},
         dict(pyramid_height=2, pooling_type="avg"), [], ["Out"], ["X"],
         "Out"),
        ("norm", "norm", {"X": [f(2, 3, 4, 4)], "Scale": [
            rng.uniform(0.5, 1.5, 3).astype(np.float32)]},
         dict(epsilon=1e-10), [], ["Out"], ["X", "Scale"], "Out"),
        ("bilinear_tensor_product", "bilinear_tensor_product",
         {"X": [f(3, 4)], "Y": [f(3, 5)], "Weight": [f(6, 4, 5) * 0.3],
          "Bias": [f(1, 6)]}, {}, [], ["Out"],
         ["X", "Y", "Weight", "Bias"], "Out"),
        ("modified_huber_loss", "modified_huber_loss",
         {"X": [rng.uniform(-2.5, 2.5, (8, 1)).astype(np.float32)],
          "Y": [rng.randint(0, 2, (8, 1)).astype(np.float32)]}, {}, [],
         ["IntermediateVal", "Out"], ["X"], "Out"),
        ("soft_relu", "soft_relu", {"X": [f(3, 4)]},
         dict(threshold=40.0), [], ["Out"], ["X"], "Out"),
        ("soft_relu saturated", "soft_relu", {"X": [f(3, 4) * 3]},
         dict(threshold=1.5), [], ["Out"], ["X"], "Out"),
        ("average_accumulates (shift)", "average_accumulates",
         {"Param": [f(4, 3)], "InSum1": [f(4, 3)], "InSum2": [f(4, 3)],
          "InSum3": [f(4, 3)],
          "InNumAccumulates": [np.array([3], np.int32)],
          "InOldNumAccumulates": [np.array([5], np.int32)],
          "InNumUpdates": [np.array([7], np.int32)]},
         dict(average_window=0.5, min_average_window=2,
              max_average_window=100),
         ["OutNumAccumulates", "OutOldNumAccumulates", "OutNumUpdates"],
         ["OutSum1", "OutSum2", "OutSum3"], [], None),
        ("average_accumulates (fold)", "average_accumulates",
         {"Param": [f(4, 3)], "InSum1": [f(4, 3)], "InSum2": [f(4, 3)],
          "InSum3": [f(4, 3)],
          "InNumAccumulates": [np.array([10], np.int32)],
          "InOldNumAccumulates": [np.array([0], np.int32)],
          "InNumUpdates": [np.array([15], np.int32)]},
         dict(average_window=1.0, min_average_window=1000,
              max_average_window=10000, k_max_num_accumulates=16),
         ["OutNumAccumulates", "OutOldNumAccumulates", "OutNumUpdates"],
         ["OutSum1", "OutSum2", "OutSum3"], [], None),
    ]
    return cases


def phase_rest_op_parity(torch, fluid, place=None, card="cpu"):
    """Phase 33: the last 14 ops of the port on the card against the same
    kernels on the CPU on the same seeded inputs, forward and gradient
    (tests/test_op_numeric.py's shapes; f32, TF32 off): within 1e-5
    relative to each output's largest magnitude; integer outputs (the
    pool masks, the averaging counters) equal.
    gaussian_random_noise runs through the executor on each device from
    one seed: the threefry uniforms behind it are equal bit for bit, and
    the samples (erfinv of them, CUDA's or the CPU's) agree within 1e-5
    (reported bit-equal or not)."""
    dev = "cuda" if place is None else fluid.Executor(place).device.type
    rng = np.random.RandomState(33)
    results = {}
    for (name, op, ins, attrs, exact, floats, wrt, out) in \
            rest_op_cases(rng):
        kw = dict(keep=tuple(exact + floats), wrt=wrt, out=out)
        c, cg = _kernel_run(torch, dev, op, ins, attrs, **kw)
        h, hg = _kernel_run(torch, "cpu", op, ins, attrs, **kw)
        same = all(np.array_equal(c[s], h[s]) and c[s].dtype == h[s].dtype
                   for s in exact)
        errs = [_rel_err(c[s], h[s]) for s in floats] + \
            [_rel_err(a, b) for a, b in zip(cg, hg)]
        err = max(errs) if errs else 0.0
        ok = same and err <= 1e-5
        _on_card(card, "%s: %smax rel diff card vs CPU %.3e (outputs%s) "
                 "%s" % (name, "%s equal, " % ", ".join(exact) if exact
                         else "", err, " and gradients towards %s"
                         % ", ".join(wrt) if wrt else "",
                         "ok" if ok else "FAIL"))
        check(ok, "phase 33: %s differs on the card" % name)
        results[name] = dict(rel_err=err, exact=same)
    x = np.random.RandomState(34).randn(4, 3, 8, 8).astype(np.float32)
    noise = {}
    for side, where in (("card", place or fluid.CUDAPlace(0)),
                        ("cpu", fluid.CPUPlace())):
        main = fluid.Program()
        block = main.global_block()
        block.create_var(name="x", shape=(-1, 3, 8, 8), dtype="float32",
                         is_data=True)
        block.create_var(name="y", dtype="float32")
        block.append_op(type="gaussian_random_noise", inputs={"X": ["x"]},
                        outputs={"Out": ["y"]}, attrs={"std": 0.5})
        main.random_seed = 7
        (noise[side],) = fluid.Executor(where).run(
            main, feed={"x": x}, fetch_list=["y"])
    err = _rel_err(noise["card"], noise["cpu"])
    equal = bool(np.array_equal(noise["card"], noise["cpu"]))
    # the random part: the threefry uniforms behind the samples, equal
    # bit for bit (erfinv, CUDA's or the CPU's, maps them to normals)
    from paddle_tpu_torch.utils import prng

    key = prng.fold_in(prng.fold_in(prng.PRNGKey(7), 1), 1)
    lo = np.nextafter(np.float32(-1.0), np.float32(0.0))
    u = [prng.uniform(key.to(d), x.shape, lo, 1.0).cpu().numpy()
         for d in (dev, "cpu")]
    bits = bool(np.array_equal(u[0], u[1]))
    ok = err <= 1e-5 and bits and \
        0.45 < float((noise["cpu"] - x).std()) < 0.55
    _on_card(card, "gaussian_random_noise (executor, seed 7, std 0.5, "
             "[4, 3, 8, 8]): threefry uniforms bit-equal %s; samples %s, max "
             "rel diff card vs CPU %.3e %s"
             % (bits, "bit-equal" if equal else "not bit-equal", err,
                "ok" if ok else "FAIL"))
    check(ok, "phase 33: gaussian_random_noise differs on the card")
    results["gaussian_random_noise"] = dict(rel_err=err, bit_equal=equal,
                                            uniform_bits_equal=bits)
    return results


def _steps_from(fluid, exe, main, weights, feed, fetch, n, dev):
    """n executor runs of `main` from `weights` in a fresh scope: (loss
    of each, final scope as numpy)."""
    scope = fluid.scope_from_numpy(fluid.Scope(), weights, dev)
    with fluid.scope_guard(scope):
        losses = [float(exe.run(main, feed=feed, fetch_list=[fetch])[0]
                        .reshape(-1)[0]) for _ in range(n)]
    return losses, fluid.scope_to_numpy(scope)


def phase_resnet_remat(torch, fluid, resnet, phase16, warm=2, steps=10,
                       place=None, cfg=FLUID_RESNET, parity=REMAT_PARITY,
                       card="cpu"):
    """Phase 34: bench.py's resnet50_remat cell (bench.py:4446-4448):
    ResNet-50 at phase 16's configuration (batch 128, [3, 224, 224],
    1000 classes, bf16 AMP, Momentum(0.01, 0.9)) under
    fluid.memory_optimize: 2 warm-up and 10 timed steps on one batch
    (ms/step, img/s, peak device memory beside phase 16's, measured in
    this run); losses finite and falling. From one set of startup
    weights the unmarked and the marked program's first two bf16 losses
    agree within rtol 2e-2 (tests/test_memory_optimize.py's AMP bar), and
    in f32 at batch 16 their parameters after one step within 1e-5."""
    model = lambda x, c: resnet.resnet_imagenet(  # noqa: E731
        x, c, depth=cfg["depth"])
    out = {}
    torch.backends.cudnn.benchmark = True
    try:
        main, startup, avg = fluid_image_program(
            fluid, model, cfg["shape"], cfg["classes"], amp=True)
        fluid.memory_optimize(main)
        scope = fluid.Scope()
        with fluid.scope_guard(scope):
            exe = fluid.Executor(place or fluid.CUDAPlace(0))
            dev = exe.device
            exe.run(startup)
            weights = fluid.scope_to_numpy(scope)
            feed = image_feed(torch, cfg["batch"], cfg["shape"],
                              cfg["classes"], dev)

            def step():
                return exe.run(main, feed=feed, fetch_list=[avg],
                               return_numpy=False)[0]

            losses, warm_s, wall, peak = _timed_steps(torch, step, dev,
                                                      warm, steps)
        del scope
        losses = [float(x.reshape(())) for x in losses]
        ok = all(math.isfinite(x) for x in losses) and losses[-1] < losses[0]
        ips = cfg["batch"] * steps / wall
        _on_card(card, "memory_optimize: %d steps of batch %d, bf16 AMP: "
                 "%.3f ms/step, %.1f img/s, peak device memory %.3f GiB "
                 "(phase 16, unmarked, this run: %.3f ms/step, %.1f img/s, "
                 "%.3f GiB); losses %s %s" % (
                     steps, cfg["batch"], wall / steps * 1e3, ips,
                     peak / 2 ** 30, phase16["ms_per_step"],
                     phase16["img_per_s"], phase16["peak_mem_gib"],
                     ", ".join("%.4f" % x for x in losses),
                     "ok" if ok else "FAIL"))
        check(ok, "phase 34: the remat loss is not finite or did not "
              "fall: %s" % losses)
        out.update(ms_per_step=wall / steps * 1e3, img_per_s=ips,
                   peak_mem_gib=peak / 2 ** 30, warm_s=warm_s,
                   losses=losses,
                   phase16=dict((k, phase16[k]) for k in (
                       "ms_per_step", "img_per_s", "peak_mem_gib")))

        # bf16: unmarked vs marked, two steps from the same weights (a
        # clone keeps the variable names)
        plain = main.clone()
        plain.remat = False
        l_plain, _ = _steps_from(fluid, exe, plain, weights, feed, avg, 2,
                                 dev)
        l_remat, _ = _steps_from(fluid, exe, main, weights, feed, avg, 2,
                                 dev)
        diff = max(abs(a - b) / abs(b) for a, b in zip(l_remat, l_plain))
        ok = diff <= 2e-2
        _on_card(card, "bf16 batch %d, unmarked vs marked from one set of "
                 "weights: losses %s vs %s, max rel diff %.3e %s" % (
                     cfg["batch"], ["%.5f" % x for x in l_plain],
                     ["%.5f" % x for x in l_remat], diff,
                     "ok" if ok else "FAIL"))
        check(ok, "phase 34: remat bf16 losses differ from the unmarked "
              "program's")
        out["bf16_loss_rel_diff"] = diff
        del weights, feed

        # f32 at batch 16: parameters after one step
        m32, s32, a32 = fluid_image_program(
            fluid, model, parity["shape"], parity["classes"], amp=False)
        marked = m32.clone()
        fluid.memory_optimize(marked)
        scope0 = fluid.Scope()
        with fluid.scope_guard(scope0):
            exe.run(s32)
        w0 = fluid.scope_to_numpy(scope0)
        del scope0
        feed = image_feed(torch, parity["batch"], parity["shape"],
                          parity["classes"], dev)
        # deterministic cuDNN algorithms: both runs pick the same ones,
        # and none sums with atomics
        torch.backends.cudnn.deterministic = True
        try:
            _, st_plain = _steps_from(fluid, exe, m32, w0, feed, a32, 1,
                                      dev)
            _, st_remat = _steps_from(fluid, exe, marked, w0, feed, a32, 1,
                                      dev)
        finally:
            torch.backends.cudnn.deterministic = False
        params = [p.name for p in m32.global_block().all_parameters()]
        moved = max(float(np.abs(st_plain[n] - w0[n]).max())
                    for n in params)
        p_err = max(float(np.abs(st_remat[n] - st_plain[n]).max())
                    for n in params)
        s_err = max(_rel_err(st_remat[n], st_plain[n]) for n in st_plain
                    if n not in params)
        ok = p_err <= 1e-5 and moved > 0
        _on_card(card, "f32 ResNet-50 batch %d, one Momentum step, unmarked "
                 "vs marked (cuDNN deterministic): max parameter diff %.3e "
                 "(the step moved them up to %.3e); batch-norm statistics "
                 "and velocities max rel diff %.3e %s" % (
                     parity["batch"], p_err, moved, s_err,
                     "ok" if ok else "FAIL"))
        check(ok, "phase 34: remat f32 parameters differ after one step")
        out.update(f32_param_abs_err=p_err, f32_state_rel_err=s_err)
    finally:
        torch.backends.cudnn.benchmark = False
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
    return out


def phase_grad_accum(torch, fluid, resnet, lenet, warm=2, steps=3,
                     place=None, cfg=ACCUM_RESNET, lenet_cfg=None,
                     card="cpu"):
    """Phase 35: Executor.run_grad_accum. ResNet-50 in f32 at batch 128
    with micro_batches=4 beside a plain f32 batch-128 step (ms/step and
    peak device memory of 3 timed steps after 2 warm-up ones); LeNet
    (no batch norm) at batch 64 in 4 chunks: its updated parameters
    equal one full-batch step's within 1e-5 from the same weights."""
    lenet_cfg = lenet_cfg or BOOK_IMAGE["lenet_mnist"]
    out = {}
    torch.backends.cudnn.benchmark = True
    try:
        main, startup, avg = fluid_image_program(
            fluid, lambda x, c: resnet.resnet_imagenet(
                x, c, depth=cfg["depth"]),
            cfg["shape"], cfg["classes"], amp=False)
        for mode in ("plain", "accum"):
            scope = fluid.Scope()
            with fluid.scope_guard(scope):
                exe = fluid.Executor(place or fluid.CUDAPlace(0))
                dev = exe.device
                exe.run(startup)
                feed = image_feed(torch, cfg["batch"], cfg["shape"],
                                  cfg["classes"], dev)
                if mode == "plain":
                    def step():
                        return exe.run(main, feed=feed, fetch_list=[avg],
                                       return_numpy=False)[0]
                else:
                    def step():
                        return exe.run_grad_accum(
                            main, feed=feed, fetch_list=[avg],
                            micro_batches=cfg["micro_batches"],
                            return_numpy=False)[0]
                losses, _, wall, peak = _timed_steps(
                    torch, step, dev, warm, steps)
            losses = [float(x.reshape(())) for x in losses]
            ok = all(math.isfinite(x) for x in losses)
            _on_card(card, "ResNet-50 f32 batch %d, %s: %.3f ms/step, "
                     "%.1f img/s, peak device memory %.3f GiB; losses %s %s"
                     % (cfg["batch"], "one step" if mode == "plain" else
                        "run_grad_accum, %d micro-batches of %d" % (
                            cfg["micro_batches"],
                            cfg["batch"] // cfg["micro_batches"]),
                        wall / steps * 1e3, cfg["batch"] * steps / wall,
                        peak / 2 ** 30,
                        ", ".join("%.4f" % x for x in losses),
                        "ok" if ok else "FAIL"))
            check(ok, "phase 35: a %s ResNet-50 loss is not finite" % mode)
            out["resnet50_" + mode] = dict(
                ms_per_step=wall / steps * 1e3,
                img_per_s=cfg["batch"] * steps / wall,
                peak_mem_gib=peak / 2 ** 30, losses=losses)
            del scope, feed, step
            if torch.cuda.is_available():
                torch.cuda.empty_cache()
    finally:
        torch.backends.cudnn.benchmark = False

    main, startup, avg = fluid_image_program(
        fluid, lenet.lenet, lenet_cfg["shape"], lenet_cfg["classes"],
        amp=False)
    exe = fluid.Executor(place or fluid.CUDAPlace(0))
    scope0 = fluid.Scope()
    with fluid.scope_guard(scope0):
        exe.run(startup)
    w0 = fluid.scope_to_numpy(scope0)
    feed = book_image_feed(torch, lenet_cfg, lenet_cfg["batch"], exe.device)
    finals = {}
    for k in (None, 4):
        scope = fluid.scope_from_numpy(fluid.Scope(), w0, exe.device)
        with fluid.scope_guard(scope):
            if k is None:
                exe.run(main, feed=feed, fetch_list=[avg])
            else:
                exe.run_grad_accum(main, feed=feed, fetch_list=[avg],
                                   micro_batches=k)
        finals[k] = fluid.scope_to_numpy(scope)
    params = [p.name for p in main.global_block().all_parameters()]
    err = max(float(np.abs(finals[4][n] - finals[None][n]).max())
              for n in params)
    moved = max(float(np.abs(finals[None][n] - w0[n]).max())
                for n in params)
    ok = err <= 1e-5 and moved > 1e-4
    _on_card(card, "LeNet batch %d: 4 accumulated chunks vs one full-batch "
             "step from the same weights: max parameter diff %.3e (the step "
             "moved them up to %.3e) %s" % (lenet_cfg["batch"], err, moved,
                                            "ok" if ok else "FAIL"))
    check(ok, "phase 35: LeNet's accumulated step differs from the "
          "full-batch step")
    out["lenet_param_abs_err"] = err
    return out


def ma_prune_program(fluid, vgg, cfg, opt):
    """VGG-16-bn-drop (the book's CIFAR-10 net) with StaticPruning at
    sparsity 0.5 on its fc weights and ModelAverage(0.15): (main,
    startup, for_test clone, loss, pruning, average)."""
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        image = fluid.layers.data(name="image", shape=cfg["shape"],
                                  dtype="float32")
        label = fluid.layers.data(name="label", shape=[1], dtype="int64")
        predict = vgg.vgg16_bn_drop(image, cfg["classes"])
        avg = fluid.layers.mean(
            x=fluid.layers.cross_entropy(input=predict, label=label))
        test = main.clone(for_test=True)
        opt(fluid).minimize(avg)
        block = main.global_block()
        fc = {op.input("Y")[0] for op in block.ops if op.type == "mul"}
        pruning = fluid.optimizer.StaticPruning(sparsity_ratio=0.5).build(
            main, startup, targets=[p for p in block.all_parameters()
                                    if p.name in fc])
        average = fluid.optimizer.ModelAverage(average_window=0.15).build()
    return main, startup, test, avg, pruning, average


def _pruned_ok(torch, scope, pruning):
    """(every pruned entry exactly zero, fraction pruned, the stated
    fraction) over the pruned weights, read back together."""
    bad, zeros, total, want = [], [], 0, 0
    for pname, mname in pruning.masks.items():
        w, m = scope.get(pname), scope.get(mname)
        bad.append(((m == 0) & (w != 0)).sum())
        zeros.append((m == 0).sum())
        keep = max(1, int(round(m.numel() * 0.5)))
        total += m.numel()
        want += m.numel() - keep
    b, z = torch.stack(bad).sum().item(), torch.stack(zeros).sum().item()
    return b == 0, z / total, want / total


def phase_ma_prune(torch, fluid, vgg, steps=30, place=None, card="cpu"):
    """Phase 36: phase 29's VGG-16-bn-drop CIFAR-10 (batch 128, f32,
    Adam(1e-3)) with StaticPruning at sparsity 0.5 on its fc weights and
    ModelAverage(0.15): 30 steps, after every one the pruned weights are
    exactly zero at the stated fraction; the for_test clone evaluated
    under apply() (the averages zero where pruned), then restore() gives
    the raw weights back bit for bit. Card vs CPU at phase 29's parity
    batch (32) under Momentum(0.01, 0.9) for 3 steps: losses within rtol
    1e-4, parameters and batch-norm statistics within atol 1e-4 (phase
    29's bar), the averaged weights within 1e-4, the counters equal; the
    window sums and velocities are reported."""
    cfg = BOOK_IMAGE["vgg16_bn_drop_cifar10"]
    adam = lambda f: f.optimizer.Adam(learning_rate=1e-3)  # noqa: E731
    main, startup, test, avg, pruning, average = ma_prune_program(
        fluid, vgg, cfg, adam)
    out = {}
    scope = fluid.Scope()
    with fluid.scope_guard(scope):
        exe = fluid.Executor(place or fluid.CUDAPlace(0))
        exe.run(startup)
        feed = book_image_feed(torch, cfg, cfg["batch"], exe.device)
        losses, fracs = [], []
        t0 = time.monotonic()
        for _ in range(steps):
            losses.append(float(exe.run(main, feed=feed, fetch_list=[avg])
                                [0].reshape(-1)[0]))
            zero, frac, want = _pruned_ok(torch, scope, pruning)
            check(zero and frac == want, "phase 36: a pruned weight is "
                  "not zero, or the fraction %.6f is not %.6f"
                  % (frac, want))
            fracs.append(frac)
        wall = time.monotonic() - t0
        raw = {p: scope.get(p).clone() for p in average._param_names}
        with average.apply(scope=scope):
            (t_loss,) = exe.run(test, feed=feed, fetch_list=[avg.name])
            sparse_avg = all(
                bool(((scope.get(m) == 0) & (scope.get(p) != 0)).sum()
                     .item() == 0) for p, m in pruning.masks.items())
        restored = all(torch.equal(scope.get(p), raw[p]) for p in raw)
        (live_loss,) = exe.run(test, feed=feed, fetch_list=[avg.name])
    ok = all(math.isfinite(x) for x in losses) and \
        np.mean(losses[-5:]) < np.mean(losses[:5]) and sparse_avg and \
        restored
    _on_card(card, "VGG-16-bn-drop CIFAR-10 batch %d, Adam(1e-3), fc "
             "weights pruned at 0.5 (%d tensors), ModelAverage(0.15) over "
             "%d parameters: %d steps in %.3f s (with the per-step checks); "
             "pruned entries exactly zero after every step at fraction "
             "%.6f; losses %.4f -> %.4f; test loss under apply() %.4f "
             "(averages zero where pruned: %s), live %.4f; restore() bit "
             "for bit: %s %s" % (
                 cfg["batch"], len(pruning.masks),
                 len(average._param_names), steps, wall, fracs[-1],
                 losses[0], losses[-1], float(np.ravel(t_loss)[0]),
                 sparse_avg, float(np.ravel(live_loss)[0]), restored,
                 "ok" if ok else "FAIL"))
    check(ok, "phase 36: pruning / averaging failed: losses %s, sparse "
          "averages %s, restored %s" % (losses, sparse_avg, restored))
    out.update(losses=losses, pruned_fraction=fracs[-1],
               averaged_test_loss=float(np.ravel(t_loss)[0]),
               restored_bit_for_bit=restored, seconds=wall)
    del scope, exe, feed

    momentum = lambda f: f.optimizer.Momentum(  # noqa: E731
        learning_rate=0.01, momentum=0.9)
    main, startup, test, avg, pruning, average = ma_prune_program(
        fluid, vgg, cfg, momentum)

    def train(exe):
        feed = book_image_feed(torch, cfg, cfg["parity_batch"], exe.device,
                               1)
        losses = [float(exe.run(main, feed=feed, fetch_list=[avg])[0][0])
                  for _ in range(3)]
        sc = fluid.global_scope()
        with average.apply(scope=sc):
            averaged = {p: fluid.as_numpy(sc.get(p))
                        for p in average._param_names}
        return losses, averaged

    # deterministic cuDNN algorithms: the card's side repeats run to run
    torch.backends.cudnn.deterministic = True
    try:
        runs, _ = _card_and_cpu(fluid, startup, train, place)
    finally:
        torch.backends.cudnn.deterministic = False
    ((lc, ac), sc), ((lh, ah), sh) = runs["card"], runs["cpu"]
    loss_err = max(abs(a - b) / abs(b) for a, b in zip(lc, lh))
    # phase 29's comparison: the parameters and the batch-norm statistics
    block = main.global_block()
    state = {p.name for p in block.all_parameters()}
    for op in block.ops:
        if op.type == "batch_norm":
            state |= set(op.input("Mean") + op.input("Variance"))
    ints = [n for n in sh if sh[n].dtype.kind in "iu"]
    worst = sorted((float(np.abs(sc[n] - sh[n]).max()), n) for n in state)
    p_err = worst[-1][0]
    a_err = max(float(np.abs(ac[n] - ah[n]).max()) for n in ah)
    rest = sorted((_rel_err(sc[n], sh[n]), n) for n in sh
                  if n not in state and n not in ints)[-2:]
    same = all(np.array_equal(sc[n], sh[n]) for n in ints)
    ok = loss_err <= 1e-4 and p_err <= 1e-4 and a_err <= 1e-4 and same
    _on_card(card, "card vs CPU, 3 Momentum steps at batch %d with pruning "
             "and averaging: max rel loss diff %.3e, max parameter / "
             "batch-norm statistic diff %.3e, averaged weights %.3e, %d "
             "counters equal: %s; the largest parameter / statistic "
             "diffs %s; the other state (window sums, velocities, masks) "
             "by max rel diff: %s %s" % (
                 cfg["parity_batch"], loss_err, p_err, a_err, len(ints),
                 same, ", ".join("%s %.3e (of %.3e)" % (
                     n, e, float(np.abs(sh[n]).max())) for e, n in worst[-3:]),
                 ", ".join("%s %.3e" % (n, e) for e, n in rest),
                 "ok" if ok else "FAIL"))
    check(ok, "phase 36: pruning / averaging on the card diverged from "
          "the CPU")
    out.update(loss_rel_err=loss_err, state_abs_err=p_err,
               averaged_abs_err=a_err)
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
    return out


class _RunRecorder(object):
    """Records the (program, feed names, fetch names) of every executor
    run while active, through the hook each run entry point calls
    (Executor._maybe_preflight), so that phase 37 can verify them all.
    The runs themselves are unchanged: the verifier stays off in the
    timed windows, and recording costs one dict update a run."""

    def __init__(self, fluid):
        self.executor, self.fluid = fluid.Executor, fluid
        self.runs = {}

    def __enter__(self):
        real = self.real = self.executor._maybe_preflight
        runs, default = self.runs, self.fluid.default_main_program

        def recorded(exe, program, feed, fetch_list, force=False):
            prog = program if program is not None else default()
            fetches = tuple(sorted(f.name if hasattr(f, "name") else str(f)
                                   for f in fetch_list or ()))
            runs.setdefault((prog.uid, frozenset(feed or ()), fetches),
                            prog)
            real(exe, program, feed, fetch_list, force)
        self.executor._maybe_preflight = recorded
        return self

    def __exit__(self, *exc):
        self.executor._maybe_preflight = self.real

    def verify(self):
        """(number of runs verified, error diagnostics found) over the
        recorded runs, each program as it stands now."""
        from paddle_tpu_torch.analysis.program_lint import verify_program

        errors = []
        for (_, feeds, fetches), prog in self.runs.items():
            errors += [d for d in verify_program(
                prog, feeds=feeds, fetches=fetches,
                label="<program uid=%d>" % prog.uid)
                if d.severity == "error"]
        return len(self.runs), errors


def _malformed(fluid, kind):
    p = fluid.Program()
    b = p.global_block()
    b.create_var(name="x", shape=(4,), dtype="float32", is_data=True)
    b.create_var(name="y", shape=(4,), dtype="int32", is_data=True)
    b.create_var(name="out", shape=(4,), dtype="float32")
    other = "ghost" if kind == "P001" else "y"
    b.append_op("elementwise_add", inputs={"X": ["x"], "Y": [other]},
                outputs={"Out": ["out"]})
    return p


def phase_executor_surface(torch, fluid, resnet, lenet, recorder,
                           place=None, card="cpu", feeder_cfg=FLUID_RESNET,
                           feeder_steps=10, profile_cfg=PROFILE_RESNET):
    """Phase 37: the executor's surface on the card. The verifier passes
    every (program, feed, fetch) phases 16-36 ran (recorded then, checked
    here, so their timed windows ran without it); two malformed programs
    raise P001 and P003 through run(validate=True). PADDLE_TPU_CHECK_NUMERICS=1 names an injected NaN and passes a
    clean LeNet step. ResNet-50 at batch 128 (bf16 AMP) is fed 10 steps
    from pinned host batches through AsyncDeviceFeeder and through the
    synchronous feed from the same weights, cuDNN deterministic: losses
    equal, img/s of both. profiler() and trace_profile on ResNet-50 at
    batch 32 (bench.py:763): the top rows, measured_total_ms,
    unmatched_ms and top5_max_disagreement (reported, not gated); gated:
    the measured rows hold between 0.9 and 1.01 of the profiled device
    time."""
    import os

    from paddle_tpu_torch.analysis import ProgramVerifyError
    from paddle_tpu_torch.fluid import profiler
    from paddle_tpu_torch.fluid.data_feeder import AsyncDeviceFeeder

    out = {}
    where = place or fluid.CUDAPlace(0)
    exe = fluid.Executor(where)
    dev = exe.device
    codes = {}
    for kind in ("P001", "P003"):
        feed = {"x": np.ones(4, np.float32), "y": np.ones(4, np.int32)}
        try:
            exe.run(_malformed(fluid, kind), feed=feed, fetch_list=["out"],
                    validate=True)
            codes[kind] = []
        except ProgramVerifyError as e:
            codes[kind] = [d.code for d in e.diagnostics]
    n_runs, errors = recorder.verify()
    ok = n_runs > 0 and not errors and all(
        codes[k] == [k] for k in codes)
    _on_card(card, "verifier: %d distinct (program, feed, fetch) runs of "
             "phases 16-36, %d errors %s; run(validate=True) raised %s %s"
             % (n_runs, len(errors), [d.fingerprint for d in errors[:3]], codes,
                "ok" if ok else "FAIL"))
    check(ok, "phase 37: the verifier refused a run of phases 16-36 or "
          "missed a malformed program")
    out["verified_runs"] = n_runs

    # the numerics guard
    os.environ["PADDLE_TPU_CHECK_NUMERICS"] = "1"
    try:
        main, startup = fluid.Program(), fluid.Program()
        with fluid.program_guard(main, startup):
            x = fluid.layers.data("x", shape=[4], dtype="float32")
            m = fluid.layers.mean(x=x)
        bad = {"x": np.array([[1.0, np.nan, 2.0, 3.0]], np.float32)}
        try:
            exe.run(main, feed=bad, fetch_list=[m, "x"])
            msg = None
        except FloatingPointError as e:
            msg = str(e)
        lmain, lstart, lavg = fluid_image_program(
            fluid, lenet.lenet, [1, 28, 28], 10, amp=False)
        with fluid.scope_guard(fluid.Scope()):
            exe.run(lstart)
            (clean,) = exe.run(lmain, feed=book_image_feed(
                torch, BOOK_IMAGE["lenet_mnist"], 64, dev),
                fetch_list=[lavg])
    finally:
        os.environ.pop("PADDLE_TPU_CHECK_NUMERICS", None)
    ok = msg is not None and "fetch %r (1/1 non-finite)" % m.name in msg \
        and "fetch 'x' (1/4 non-finite)" in msg and \
        math.isfinite(float(clean[0]))
    _on_card(card, "PADDLE_TPU_CHECK_NUMERICS=1: %r; a clean LeNet step "
             "passed (loss %.4f) %s" % (msg, float(clean[0]),
                                        "ok" if ok else "FAIL"))
    check(ok, "phase 37: the numerics guard missed the NaN or refused a "
          "clean step")

    # AsyncDeviceFeeder vs the synchronous feed
    cfg = feeder_cfg
    main, startup, avg = fluid_image_program(
        fluid, lambda x, c: resnet.resnet_imagenet(x, c, depth=cfg["depth"]),
        cfg["shape"], cfg["classes"], amp=True)
    rng = np.random.RandomState(37)
    def pinned(a):
        t = torch.from_numpy(a)
        return t.pin_memory() if dev.type == "cuda" else t

    batches = [{"image": pinned(rng.rand(cfg["batch"], *cfg["shape"]).astype(
        np.float32)), "label": pinned(rng.randint(
            0, cfg["classes"], (cfg["batch"], 1)).astype(np.int64))}
        for _ in range(feeder_steps)]
    scope0 = fluid.Scope()
    with fluid.scope_guard(scope0):
        exe.run(startup)
    w0 = fluid.scope_to_numpy(scope0)
    del scope0
    runs = {}
    torch.backends.cudnn.benchmark = True
    torch.backends.cudnn.deterministic = True
    try:
        for mode in ("warm", "sync", "async"):
            scope = fluid.scope_from_numpy(fluid.Scope(), w0, dev)
            with fluid.scope_guard(scope):
                feeds = AsyncDeviceFeeder(iter(batches), capacity=2,
                                          place=where) \
                    if mode == "async" else iter(batches)
                _sync(torch, dev.type)
                t0 = time.monotonic()
                losses = [exe.run(main, feed=f, fetch_list=[avg],
                                  return_numpy=False)[0] for f in feeds]
                _sync(torch, dev.type)
                wall = time.monotonic() - t0
            runs[mode] = ([float(x.reshape(())) for x in losses],
                          cfg["batch"] * len(losses) / wall)
            del scope
    finally:
        torch.backends.cudnn.deterministic = False
        torch.backends.cudnn.benchmark = False
    ok = runs["async"][0] == runs["sync"][0] and \
        len(runs["async"][0]) == feeder_steps
    _on_card(card, "AsyncDeviceFeeder, ResNet-50 bf16 batch %d, %d pinned "
             "host batches: %.1f img/s vs %.1f img/s synchronous; losses "
             "equal: %s (%.4f -> %.4f) %s" % (
                 cfg["batch"], feeder_steps, runs["async"][1],
                 runs["sync"][1], runs["async"][0] == runs["sync"][0],
                 runs["async"][0][0], runs["async"][0][-1],
                 "ok" if ok else "FAIL"))
    check(ok, "phase 37: the fed losses differ from the synchronous "
          "feed's: %s vs %s" % (runs["async"][0], runs["sync"][0]))
    out["feeder"] = dict(async_img_per_s=runs["async"][1],
                         sync_img_per_s=runs["sync"][1],
                         losses=runs["async"][0])
    del batches, w0
    if torch.cuda.is_available():
        torch.cuda.empty_cache()

    # the profiler on bench.py:763's configuration
    cfg = profile_cfg
    main, startup, avg = fluid_image_program(
        fluid, lambda x, c: resnet.resnet_imagenet(x, c, depth=cfg["depth"]),
        cfg["shape"], cfg["classes"], amp=True)
    torch.backends.cudnn.benchmark = True
    try:
        with fluid.scope_guard(fluid.Scope()):
            exe.run(startup)
            feed = image_feed(torch, cfg["batch"], cfg["shape"],
                              cfg["classes"], dev)
            exe.run(main, feed=feed, fetch_list=[avg])
            with profiler.profiler("All", sorted_key="total"):
                for _ in range(2):
                    exe.run(main, feed=feed, fetch_list=[avg])
            table = profiler.last_profile()
            rows, meta = profiler.trace_profile(exe, main, feed, [avg],
                                                runs=3)
    finally:
        torch.backends.cudnn.benchmark = False
    covered = meta["matched_ms"] / max(meta["measured_total_ms"], 1e-9)
    # on the CPU (a rehearsal) the rows read host time, which the
    # executor's own work dilutes: the gate is the card's. Rows holding
    # more than the device ran would be kernels counted twice.
    ok = bool(table) and any(r["Event"] == profiler.BACKWARD_ROW
                             for r in table) and (
        0.9 <= covered <= 1.01 or dev.type != "cuda")
    for r in rows[:6]:
        _on_card(card, "trace_profile row %-24s measured %.4f ms (share "
                 "%.4f), modelled share %.4f, disagreement %.4f" % (
                     r["Event"], r["measured_ms"], r["measured_share"],
                     r["modeled_share"], r["disagreement"]))
    _on_card(card, "profiler(): %d rows, top %s; trace_profile: "
             "measured_total_ms %.4f, unmatched_ms %.4f, rows hold %.4f of "
             "the device time, top5_max_disagreement %.4f (reported, not "
             "gated) %s" % (
                 len(table), ["%s %.3f ms" % (r["Event"], r["Total"])
                              for r in table[:4]],
                 meta["measured_total_ms"], meta["unmatched_ms"], covered,
                 meta["top5_max_disagreement"], "ok" if ok else "FAIL"))
    check(ok, "phase 37: the profiler's rows do not cover the device time")
    out["profiler"] = dict(top_rows=table[:6], trace_rows=rows[:6],
                           measured_total_ms=meta["measured_total_ms"],
                           unmatched_ms=meta["unmatched_ms"],
                           covered=covered,
                           top5_max_disagreement=meta[
                               "top5_max_disagreement"])
    return out


# ---------------------------------------------------------------------
# phases 38-39: the mesh executor (paddle_tpu_torch/parallel/mesh.py)
# ---------------------------------------------------------------------

# phase 39's LeNet and DeepFM configurations: the book's MNIST batch 64
# in f32 with Momentum (LeNet's one fc split over 'model' for tensor
# parallelism), and phase 27's DeepFM at full width with its two tables
# split along their rows over 'model'
MESH_LENET = dict(BOOK_IMAGE["lenet_mnist"], steps=3)
MESH_CTR = dict(CTR, steps=2)
MESH_ASYNC_STEPS = 4


def _params_of(fluid, main, scope):
    """Every parameter's whole value, in all_parameters order."""
    with fluid.scope_guard(scope):
        return [fluid.fetch_var(p.name)
                for p in main.global_block().all_parameters()]


def _rel_diff(got, want):
    """max |got - want| over max |want| of each tensor; the largest."""
    return max(float(np.abs(a.astype(np.float64) - b).max())
               / max(float(np.abs(b).max()), 1e-30)
               for a, b in zip(got, want))


def phase_mesh_world1(torch, fluid, resnet, tfa, phase16, warm=2, steps=10,
                      check_steps=2, cfg=FLUID_RESNET, card="cpu",
                      mesh=None, flash_cfg=FLUID_FLASH, turn_steps=5):
    """Phase 38: a world of one NCCL rank. ResNet-50 at phase 16's
    configuration through Executor(mesh=make_mesh({'data': 1})): the
    timed loop of phase 16 (ms/step, the gradient sync's bytes, buckets
    and device time per step, peak memory) beside phase 16's numbers;
    the plain and the mesh executor timed in turns (plain, mesh, mesh,
    plain) within one window, the host cost of the mesh path; then the
    plain executor and the mesh executor from one startup with
    cuDNN in deterministic mode, 2 steps each: losses and every
    persistable bit-equal. Last, phase 18's flash program on the mesh:
    one launch of each flash kernel. (A rehearsal passes a CPU `mesh`
    and small configurations.)"""
    from paddle_tpu_torch import parallel

    on_card = mesh is None
    mesh = mesh or parallel.make_mesh({"data": 1})
    check(not on_card or (mesh.backend == "nccl"
                          and mesh.device.type == "cuda"),
          "phase 38: the world of one is not NCCL on the card: %r" % mesh)
    out = dict(backend=mesh.backend)
    main, startup, avg = fluid_image_program(
        fluid, lambda x, c: resnet.resnet_imagenet(x, c, depth=cfg["depth"]),
        cfg["shape"], cfg["classes"], amp=True)
    torch.backends.cudnn.benchmark = True
    try:
        with fluid.scope_guard(fluid.Scope()):
            exe = fluid.Executor(mesh=mesh)
            dev = exe.device
            exe.run(startup)
            feed = image_feed(torch, cfg["batch"], cfg["shape"],
                              cfg["classes"], dev)

            def step():
                return exe.run(main, feed=feed, fetch_list=[avg],
                               return_numpy=False)[0]

            # the warm-up steps also create the NCCL communicator
            losses = [step() for _ in range(warm)]
            _sync(torch, dev.type)
            stats = mesh.sync_stats
            stats.reset()
            stats.timed = True
            if on_card:
                torch.cuda.reset_peak_memory_stats()
            t0 = time.monotonic()
            losses += [step() for _ in range(steps)]
            _sync(torch, dev.type)
            wall = time.monotonic() - t0
            stats.timed = False
            peak = torch.cuda.max_memory_allocated() if on_card else 0
            sync_ms = stats.device_ms() / steps if on_card else 0.0
        losses = [float(x.reshape(())) for x in losses]
        ref = phase16["losses"]
        same = losses == ref
        diff = max(abs(a - b) / abs(b) for a, b in zip(losses, ref))
        _on_card(card, "ResNet-50 bf16 b%d on the world-of-one NCCL mesh: "
                 "%.3f ms/step (phase 16: %.3f), peak %.2f GiB (phase 16: "
                 "%.2f); gradient sync %.0f bytes in %.1f buckets, %.4f ms "
                 "device a step; losses %s phase 16's (max rel diff %.3e)"
                 % (cfg["batch"], wall / steps * 1e3, phase16["ms_per_step"],
                    peak / 2 ** 30, phase16["peak_mem_gib"],
                    stats.bytes / steps, stats.buckets / steps,
                    sync_ms, "bit-equal to" if same else "differ from",
                    diff))
        check(all(math.isfinite(x) for x in losses) and diff < 2e-2,
              "phase 38: the mesh ResNet-50 losses %s left phase 16's %s"
              % (losses, ref))
        out.update(ms_per_step=wall / steps * 1e3,
                   phase16_ms_per_step=phase16["ms_per_step"],
                   peak_mem_gib=peak / 2 ** 30,
                   sync_bytes_per_step=stats.bytes / steps,
                   sync_buckets_per_step=stats.buckets / steps,
                   sync_device_ms_per_step=sync_ms, losses=losses,
                   losses_bit_equal_phase16=same,
                   loss_rel_diff_phase16=diff)
        del exe, feed, step
        if on_card:
            torch.cuda.empty_cache()
    finally:
        torch.backends.cudnn.benchmark = False

    # the mesh executor's host cost, within one window: the plain and
    # the mesh executor in turns (plain, mesh, mesh, plain), 5 steps a
    # turn after 2 warm-up steps each
    torch.backends.cudnn.benchmark = True
    try:
        sides = {}
        for kind in ("plain", "mesh"):
            scope = fluid.Scope()
            with fluid.scope_guard(scope):
                exe = fluid.Executor(mesh=mesh) if kind == "mesh" else \
                    fluid.Executor(fluid.CUDAPlace(0) if on_card
                                   else fluid.CPUPlace())
                exe.run(startup)
                feed = image_feed(torch, cfg["batch"], cfg["shape"],
                                  cfg["classes"], exe.device)
                for _ in range(warm):
                    exe.run(main, feed=feed, fetch_list=[avg],
                            return_numpy=False)
            sides[kind] = (scope, exe, feed)
        turns = {"plain": [], "mesh": []}
        for kind in ("plain", "mesh", "mesh", "plain"):
            scope, exe, feed = sides[kind]
            with fluid.scope_guard(scope):
                _sync(torch, exe.device.type)
                t0 = time.monotonic()
                for _ in range(turn_steps):
                    exe.run(main, feed=feed, fetch_list=[avg],
                            return_numpy=False)
                _sync(torch, exe.device.type)
                turns[kind].append((time.monotonic() - t0) / turn_steps
                                   * 1e3)
        del sides, scope, exe, feed
        if on_card:
            torch.cuda.empty_cache()
    finally:
        torch.backends.cudnn.benchmark = False
    plain_ms, mesh_ms = (float(np.mean(turns[k])) for k in ("plain", "mesh"))
    _on_card(card, "in turns (plain, mesh, mesh, plain; %d steps a turn): "
             "plain %s ms/step, mesh %s ms/step; mesh / plain %.4f"
             % (turn_steps, ["%.3f" % x for x in turns["plain"]],
                ["%.3f" % x for x in turns["mesh"]], mesh_ms / plain_ms))
    out.update(abba_plain_ms=turns["plain"], abba_mesh_ms=turns["mesh"],
               abba_mesh_over_plain=mesh_ms / plain_ms)

    # plain vs mesh from one startup, deterministic cuDNN: bit-equal
    torch.backends.cudnn.deterministic = True
    try:
        runs = {}
        for kind in ("plain", "mesh"):
            scope = fluid.Scope()
            with fluid.scope_guard(scope):
                exe = fluid.Executor(mesh=mesh) if kind == "mesh" else \
                    fluid.Executor(fluid.CUDAPlace(0) if on_card
                                   else fluid.CPUPlace())
                exe.run(startup)
                feed = image_feed(torch, cfg["batch"], cfg["shape"],
                                  cfg["classes"], exe.device)
                ls = [exe.run(main, feed=feed, fetch_list=[avg])[0]
                      for _ in range(check_steps)]
            runs[kind] = (ls, fluid.scope_to_numpy(scope))
            del scope, exe, feed
            if on_card:
                torch.cuda.empty_cache()
    finally:
        torch.backends.cudnn.deterministic = False
    (lp, sp), (lm, sm) = runs["plain"], runs["mesh"]
    bit = all(np.array_equal(a, b) for a, b in zip(lp, lm)) and \
        sp.keys() == sm.keys() and all(np.array_equal(sp[n], sm[n])
                                       for n in sp)
    _on_card(card, "deterministic cuDNN, %d steps from one startup: plain "
             "losses %s, mesh %s; losses and %d persistables %s"
             % (check_steps, [float(x[0]) for x in lp],
                [float(x[0]) for x in lm], len(sp),
                "bit-equal" if bit else "DIFFER"))
    check(bit, "phase 38: the world-of-one mesh step is not the plain step")
    out["deterministic_bit_equal"] = bit

    flash = phase_fluid_flash(torch, fluid, tfa, mesh=mesh, cfg=flash_cfg)
    out["flash_launches"] = flash["launches"]
    out["flash_max_abs_err"] = flash["max_abs_err"]
    return out


def _mesh_lenet(fluid, lenet):
    return fluid_image_program(fluid, lenet.lenet, MESH_LENET["shape"],
                               MESH_LENET["classes"], amp=False)


def _mesh_ctr(fluid, ctr):
    main, startup, _, loss, _ = ctr_program(fluid, ctr, "deepfm", MESH_CTR)
    return main, startup, loss


def _train(torch, fluid, main, startup, loss, feeds, exe):
    """Startup, then one run a feed; (losses, every parameter whole)."""
    scope = fluid.Scope()
    with fluid.scope_guard(scope):
        exe.run(startup)
        losses = [float(np.ravel(exe.run(main, feed=f,
                                         fetch_list=[loss])[0])[0])
                  for f in feeds]
    return losses, _params_of(fluid, main, scope)


def _rows_of(feed, i, n):
    """Block i of n along the batch of every feed value."""
    return {k: v[i * (v.shape[0] // n):(i + 1) * (v.shape[0] // n)]
            for k, v in feed.items()}


def _mesh_feeds(torch, dev):
    """The seeded batches phase 39 trains on (both sides build them)."""
    res = image_feed(torch, FLUID_RESNET["batch"], FLUID_RESNET["shape"],
                     FLUID_RESNET["classes"], dev)
    lenet_feeds = [book_image_feed(torch, MESH_LENET, MESH_LENET["batch"],
                                   dev, seed=s)
                   for s in range(MESH_LENET["steps"])]
    ctr_feeds = [ctr_batch(torch, dev, s, MESH_CTR)
                 for s in range(MESH_CTR["steps"])]
    async_feed = book_image_feed(torch, MESH_LENET, MESH_LENET["batch"]
                                 * MESH_ASYNC_STEPS, dev, seed=39)
    return res, lenet_feeds, ctr_feeds, async_feed


def mesh_worker(rank, tmp, dev="cuda:0"):
    """One of phase 39's two ranks (`chip_smoke.py --mesh-worker RANK
    DIR`): a gloo group over a file store in DIR, both ranks on cuda:0
    (NCCL refuses two ranks on one card, so gloo is named: a test
    configuration, not a fallback). Runs (a)-(d) and writes its results
    to DIR/rank<RANK>.npz."""
    import torch
    import torch.distributed as dist

    from paddle_tpu_torch import fluid, parallel
    from paddle_tpu_torch.models import ctr, lenet, resnet
    from paddle_tpu_torch.parallel.mesh import P

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(dev)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group("gloo", init_method="file://" + os.path.join(
        tmp, "store"), rank=rank, world_size=2)
    res, lenet_feeds, ctr_feeds, async_feed = _mesh_feeds(torch, dev)
    out = {}
    dp = parallel.make_mesh({"data": 2}, device=dev)
    tp = parallel.make_mesh({"data": 1, "model": 2}, device=dev)

    # (a) ResNet-50 f32, 64 rows a rank of the global batch of 128
    main, startup, avg = fluid_image_program(
        fluid, lambda x, c: resnet.resnet_imagenet(x, c, depth=50),
        FLUID_RESNET["shape"], FLUID_RESNET["classes"], amp=False)
    losses, params = _train(torch, fluid, main, startup, avg,
                            [_rows_of(res, rank, 2)] * 2,
                            fluid.Executor(mesh=dp))
    out["a_losses"] = np.asarray(losses)
    for i, p in enumerate(params):
        out["a_p%d" % i] = p
    del params
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    # (b) LeNet: its fc split over 'model', then FSDP over 'data'
    main, startup, avg = _mesh_lenet(fluid, lenet)
    fc_w = [op.inputs["Y"][0] for op in main.global_block().ops
            if op.type == "mul"][0]
    parallel.shard_parameter(main.global_block().var(fc_w), P("model", None))
    losses, params = _train(torch, fluid, main, startup, avg, lenet_feeds,
                            fluid.Executor(mesh=tp))
    out["b_tp_losses"] = np.asarray(losses)
    for i, p in enumerate(params):
        out["b_tp_p%d" % i] = p
    main, startup, avg = _mesh_lenet(fluid, lenet)
    sharded = parallel.shard_parameters_fsdp(main, dp, min_size=1024)
    check(len(sharded) >= 2, "phase 39: FSDP sharded %s" % sharded)
    scope_shapes = {}
    scope = fluid.Scope()
    exe = fluid.Executor(mesh=dp)
    with fluid.scope_guard(scope):
        exe.run(startup)
        losses = [float(exe.run(main, feed=_rows_of(f, rank, 2),
                                fetch_list=[avg])[0][0])
                  for f in lenet_feeds]
        for n in sharded:
            scope_shapes[n] = (tuple(scope.get(n).shape),
                               tuple(main.global_block().var(n).shape))
    out["b_fsdp_losses"] = np.asarray(losses)
    for i, p in enumerate(_params_of(fluid, main, scope)):
        out["b_fsdp_p%d" % i] = p
    out["b_fsdp_shapes"] = np.asarray(
        [list(here) + list(full) for here, full in scope_shapes.values()
         if len(here) == 2] or [[0, 0, 0, 0]])

    # (c) DeepFM, both tables split along their rows over 'model'
    main, startup, loss = _mesh_ctr(fluid, ctr)
    for t in ("fm_table", "fm_w_table"):
        parallel.shard_parameter(main.global_block().var(t), P("model", None))
    scope = fluid.Scope()
    with fluid.scope_guard(scope):
        exe = fluid.Executor(mesh=tp)
        exe.run(startup)
        losses = [float(exe.run(main, feed=f, fetch_list=[loss])[0][0])
                  for f in ctr_feeds]
        out["c_rows_here"] = np.asarray(scope.get("fm_table").shape)
    out["c_losses"] = np.asarray(losses)
    for i, p in enumerate(_params_of(fluid, main, scope)):
        out["c_p%d" % i] = p
    del scope
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    # (d) local SGD: sync_every=1 against the synchronous step on the
    # same mesh, and sync_every=4 (one round of independent replicas)
    half = {k: v.reshape((MESH_ASYNC_STEPS, -1) + tuple(v.shape[1:]))
            for k, v in async_feed.items()}
    mine = {k: v[:, rank * (v.shape[1] // 2):(rank + 1) * (v.shape[1] // 2)]
            for k, v in half.items()}
    for every in (1, MESH_ASYNC_STEPS):
        main, startup, avg = _mesh_lenet(fluid, lenet)
        scope = fluid.Scope()
        with fluid.scope_guard(scope):
            exe = fluid.Executor(mesh=dp)
            exe.run(startup)
            out["d_losses_%d" % every] = exe.run_async_local(
                main, feed=mine, fetch_list=[avg],
                steps=MESH_ASYNC_STEPS, sync_every=every)[0].ravel()
        for i, p in enumerate(_params_of(fluid, main, scope)):
            out["d%d_p%d" % (every, i)] = p
    main, startup, avg = _mesh_lenet(fluid, lenet)
    scope = fluid.Scope()
    with fluid.scope_guard(scope):
        exe = fluid.Executor(mesh=dp)
        exe.run(startup)
        out["d_sync_losses"] = exe.run_repeated(
            main, feed=mine, fetch_list=[avg], steps=MESH_ASYNC_STEPS,
            scan_feeds=True)[0].ravel()
    for i, p in enumerate(_params_of(fluid, main, scope)):
        out["dsync_p%d" % i] = p
    np.savez(os.path.join(tmp, "rank%d.npz" % rank), **out)
    dist.destroy_process_group()
    return 0


def phase_mesh_two_ranks(torch, fluid, resnet, lenet, ctr, card="cpu",
                         timeout=600, dev="cuda:0", worker_argv=None):
    """Phase 39: two ranks of this script (`--mesh-worker`) on the one
    card in a gloo group, against this process's single-device runs on
    the same seeded batches: (a) ResNet-50 f32 2 steps, 64 rows a rank
    of the global batch of 128 on {'data': 2} (batch norm over the
    global batch), losses and parameters within 1e-4 relative; (b)
    LeNet with its fc split over 'model' ({'data': 1, 'model': 2}) and
    with FSDP ({'data': 2}) 3 Momentum steps, within 1e-5; (c) DeepFM
    at full width with both tables split along their rows over 'model',
    2 Adam steps, within 2e-5 absolute; (d) run_async_local on
    {'data': 2}: sync_every=1 equals the synchronous step, sync_every=4
    equals two independent replicas averaged, within 1e-5. Relative:
    max |difference| over max |reference| of each tensor. (`dev` and
    `worker_argv` let a rehearsal run both sides on the CPU.)"""
    import tempfile

    dev = torch.device(dev)
    place = fluid.CUDAPlace(0) if dev.type == "cuda" else fluid.CPUPlace()
    res, lenet_feeds, ctr_feeds, async_feed = _mesh_feeds(torch, dev)
    ref = {}
    t0 = time.monotonic()
    main, startup, avg = fluid_image_program(
        fluid, lambda x, c: resnet.resnet_imagenet(x, c, depth=50),
        FLUID_RESNET["shape"], FLUID_RESNET["classes"], amp=False)
    ref["a"] = _train(torch, fluid, main, startup, avg, [res] * 2,
                      fluid.Executor(place))
    # the noise floor of (a): the same one-process steps on the batch
    # with its halves swapped (the loss is the same function of it)
    half = FLUID_RESNET["batch"] // 2
    swapped = {k: torch.cat([v[half:], v[:half]]) for k, v in res.items()}
    ref["a_swapped"] = _train(torch, fluid, main, startup, avg,
                              [swapped] * 2, fluid.Executor(place))
    del swapped
    _sync(torch, dev.type)
    main, startup, avg = _mesh_lenet(fluid, lenet)
    ref["b"] = _train(torch, fluid, main, startup, avg, lenet_feeds,
                      fluid.Executor(place))
    main, startup, loss = _mesh_ctr(fluid, ctr)
    ref["c"] = _train(torch, fluid, main, startup, loss, ctr_feeds,
                      fluid.Executor(place))
    # (d)'s oracle: each replica trained alone on its half, then averaged
    replicas = []
    for r in range(2):
        main, startup, avg = _mesh_lenet(fluid, lenet)
        feeds = [_rows_of(_rows_of(async_feed, s, MESH_ASYNC_STEPS), r, 2)
                 for s in range(MESH_ASYNC_STEPS)]
        replicas.append(_train(torch, fluid, main, startup, avg, feeds,
                               fluid.Executor(place))[1])
    ref["d"] = [(a + b) / 2 for a, b in zip(*replicas)]
    ref_s = time.monotonic() - t0

    if dev.type == "cuda":
        torch.cuda.empty_cache()  # the ranks need the card's memory
    tmp = tempfile.mkdtemp(prefix="chip_smoke_mesh_")
    here = os.path.abspath(__file__)
    argv = worker_argv or [sys.executable, here, "--mesh-worker"]
    t0 = time.monotonic()
    procs = [subprocess.Popen(argv + [str(r), tmp], cwd=os.path.dirname(here),
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for r in range(2)]
    try:
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline and any(
                p.poll() is None for p in procs):
            if any(p.poll() not in (None, 0) for p in procs):
                break
            time.sleep(0.2)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        outs = [p.communicate() for p in procs]
    ranks_s = time.monotonic() - t0
    for r, (p, (so, se)) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            log("  rank %d exited %s; its stderr ends:\n%s"
                % (r, p.returncode, se[-3000:]))
        check(p.returncode == 0, "phase 39: rank %d failed" % r)
    got = [dict(np.load(os.path.join(tmp, "rank%d.npz" % r)))
           for r in range(2)]

    def params(o, key):
        return [o["%s_p%d" % (key, i)]
                for i in range(sum(1 for k in o if k.startswith(key + "_p")))]

    out = dict(reference_s=ref_s, ranks_s=ranks_s)
    floor_loss = _rel_diff([np.asarray(ref["a_swapped"][0])],
                           [np.asarray(ref["a"][0])])
    floor_params = _rel_diff(ref["a_swapped"][1], ref["a"][1])
    rows = []
    for o in got:
        la1 = abs(o["a_losses"][0] - ref["a"][0][0]) / abs(ref["a"][0][0])
        la = _rel_diff([o["a_losses"]], [np.asarray(ref["a"][0])])
        pa = _rel_diff(params(o, "a"), ref["a"][1])
        lb = _rel_diff([o["b_tp_losses"], o["b_fsdp_losses"]],
                       [np.asarray(ref["b"][0])] * 2)
        pb = max(_rel_diff(params(o, "b_tp"), ref["b"][1]),
                 _rel_diff(params(o, "b_fsdp"), ref["b"][1]))
        lc = float(np.abs(o["c_losses"] - np.asarray(ref["c"][0])).max())
        pc = max(float(np.abs(a - b).max())
                 for a, b in zip(params(o, "c"), ref["c"][1]))
        d1 = max(_rel_diff([o["d_losses_1"]], [o["d_sync_losses"]]),
                 _rel_diff(params(o, "d1"), params(o, "dsync")))
        d4 = _rel_diff(params(o, "d%d" % MESH_ASYNC_STEPS), ref["d"])
        rows.append(dict(a_loss1=la1, a_loss=la, a_params=pa, b_loss=lb,
                         b_params=pb,
                         c_loss_abs=lc, c_params_abs=pc, d_sync1=d1,
                         d_local4=d4))
    worst = {k: max(r[k] for r in rows) for k in rows[0]}
    fsdp = got[0]["b_fsdp_shapes"]
    halved = all(h[0] * h[1] * 2 == f[0] * f[1]
                 for h, f in zip(fsdp[:, :2], fsdp[:, 2:]))
    rows_here = got[0]["c_rows_here"].tolist()
    bar_loss = max(1e-4, 2 * floor_loss)
    bar_params = max(1e-4, 2 * floor_params)
    _on_card(card, "two gloo ranks on %s: (a) ResNet-50 f32 {data: 2} "
             "first loss %.3e rel (bar 1e-4: batch norm over the global "
             "batch); losses %.3e, params %.3e rel against a noise floor "
             "of %.3e / %.3e (the one-process steps on the batch with its "
             "halves swapped; bars 1e-4 or twice the floor); (b) LeNet TP "
             "{data: "
             "1, model: 2} and FSDP {data: 2} losses %.3e, params %.3e rel "
             "(1e-5; FSDP shards hold half: %s); (c) DeepFM rows split "
             "(%s a rank) losses %.3e, params %.3e abs (2e-5); (d) local "
             "SGD sync_every=1 vs the synchronous step %.3e, sync_every=%d "
             "vs independent replicas averaged %.3e rel (1e-5); references "
             "%.1f s, ranks %.1f s"
             % (dev, worst["a_loss1"], worst["a_loss"], worst["a_params"],
                floor_loss, floor_params, worst["b_loss"],
                worst["b_params"], halved, rows_here, worst["c_loss_abs"],
                worst["c_params_abs"], worst["d_sync1"], MESH_ASYNC_STEPS,
                worst["d_local4"], ref_s, ranks_s))
    check(worst["a_loss1"] <= 1e-4 and worst["a_loss"] <= bar_loss
          and worst["a_params"] <= bar_params,
          "phase 39 (a): ResNet-50 on two ranks left the one-process step")
    check(worst["b_loss"] <= 1e-5 and worst["b_params"] <= 1e-5 and halved,
          "phase 39 (b): LeNet TP/FSDP left the one-process run")
    check(worst["c_loss_abs"] <= 2e-5 and worst["c_params_abs"] <= 2e-5
          and rows_here[0] * 2 == MESH_CTR["fields"] * MESH_CTR["per_field"],
          "phase 39 (c): the row-split DeepFM left the one-process run")
    check(worst["d_sync1"] <= 1e-5 and worst["d_local4"] <= 1e-5,
          "phase 39 (d): local SGD left its references")
    out.update(worst)
    out.update(fsdp_half=halved, deepfm_rows_a_rank=rows_here[0],
               a_floor_loss=floor_loss, a_floor_params=floor_params)
    return out


# ---------------------------------------------------------------------
# phase 40: the legacy `paddle train` stack on the benchmark configs
# ---------------------------------------------------------------------

# (name, config in the checkout, its default batch); every other knob
# of the configs stays at its default
LEGACY_CONFIGS = (
    ("resnet", "benchmarks/paddle/image/resnet.py", 64),
    ("alexnet", "benchmarks/paddle/image/alexnet.py", 128),
    ("googlenet", "benchmarks/paddle/image/googlenet.py", 128),
    ("smallnet", "benchmarks/paddle/image/smallnet_mnist_cifar.py", 128),
    ("vgg", "benchmarks/paddle/image/vgg.py", 64),
    ("rnn", "benchmarks/paddle/rnn/rnn.py", 128),
)
# batches: each time job's num_samples in batches (the trainer leaves
# its warm-up out of "Time:" and reports how many it timed); steps: the
# timed steps of ResNet-50's program alone and of phase 16's; args:
# extra config_args by config name; fluid: phase 16's configuration at
# resnet.py's batch; parity: smallnet's config_args for the card-vs-CPU
# and resume checks. A rehearsal on the CPU shrinks them.
LEGACY = dict(batches=15, steps=10, args={},
              fluid=dict(FLUID_RESNET, batch=64), parity={})
LEGACY_LOG_PERIOD = 5  # the CLI's --log_period


def _here(rel):
    return os.path.join(os.path.dirname(os.path.abspath(__file__)), rel)


def _fresh_legacy_names():
    """A config names its layers and parameters from counters of the
    process, which a new process starts at zero: two runs in this
    process name alike (one's checkpoint loads into the other, as across
    two `python -m paddle_tpu_torch.trainer` processes) only from zeroed
    counters."""
    from paddle_tpu_torch.fluid.core import program
    from paddle_tpu_torch.v2.layer import Layer

    Layer._counters.clear()
    program._unique_counters.clear()


def _legacy_build(path, args):
    """A config's Topology from fresh names: (topo, its cost, settings)."""
    from paddle_tpu_torch import trainer

    _fresh_legacy_names()
    state, topo, cost = trainer.build_topology(path, args)
    return topo, cost, state["settings"]


def _legacy_run(**kw):
    """One run_config from fresh names: (stats, with the cost of every
    batch it trained, its stdout, wall seconds)."""
    import contextlib
    import io

    from paddle_tpu_torch import trainer

    _fresh_legacy_names()
    buf = io.StringIO()
    t0 = time.monotonic()
    with contextlib.redirect_stdout(buf):
        stats = trainer.run_config(log_period=LEGACY_LOG_PERIOD, **kw)
    return stats, buf.getvalue(), time.monotonic() - t0


def _legacy_program_ms(torch, fluid, path, args, place, steps, warm=2):
    """ms/step of a config's program (its Topology and optimizer, as
    run_config builds them) on one fixed batch already on the device:
    the legacy lowering's step without the provider and the feeder.
    Timed twice: `read_back` fetches the cost to the host every step, as
    the trainer does; `queued` leaves it on the device and syncs once,
    as phase 16 times its program."""
    topo, cost, st = _legacy_build(path, args)
    with fluid.program_guard(topo.main_program, topo.startup_program):
        st["learning_method"].make(st["learning_rate"]).minimize(cost)
    exe = fluid.Executor(place or fluid.CUDAPlace(0))
    dev = exe.device
    rng = np.random.RandomState(0)
    batch = st["batch_size"]
    feed = {}
    for name, node in topo.data_layers().items():
        t = node.attrs["type"]
        if t.type == 3:  # an integer label
            v = rng.randint(0, t.dim, (batch, 1)).astype(np.int64)
        else:
            v = rng.rand(batch, t.dim).astype(np.float32)
        feed[name] = torch.from_numpy(v).to(dev)
    out = {}
    with fluid.scope_guard(fluid.Scope()):
        exe.run(topo.startup_program)
        for mode, numpy in (("read_back", True), ("queued", False)):
            for _ in range(warm):
                exe.run(topo.main_program, feed=feed, fetch_list=[cost],
                        return_numpy=numpy)
            _sync(torch, dev.type)
            t0 = time.monotonic()
            for _ in range(steps):
                exe.run(topo.main_program, feed=feed, fetch_list=[cost],
                        return_numpy=numpy)
            _sync(torch, dev.type)
            out[mode] = (time.monotonic() - t0) / steps * 1e3
    return out


def _legacy_saved(fluid, path):
    from paddle_tpu_torch.distributed import load_checkpoint

    scope = fluid.Scope()
    load_checkpoint(scope, path)
    return {n: np.asarray(scope.get(n)) for n in scope.keys()}


def phase_legacy(torch, fluid, resnet, card="cpu", place=None, cfg=LEGACY):
    """Phase 40 (see the module docstring); `place` (a CPUPlace) and
    `cfg` shrink it for a rehearsal on the CPU."""
    import shutil
    import tempfile

    from paddle_tpu_torch.distributed import save_checkpoint

    use_gpu = place is None
    paths = dict((n, _here(r)) for n, r, _ in LEGACY_CONFIGS)
    out = {"card": card, "batches": cfg["batches"]}
    torch.backends.cudnn.benchmark = True
    try:
        prog = _legacy_program_ms(torch, fluid, paths["resnet"],
                                  cfg["args"].get("resnet", {}), place,
                                  cfg["steps"])
        out["resnet_program_ms"] = prog
        log("  resnet.py's program alone, one fixed batch on the device: "
            "%.3f ms/step reading the cost back every step, %.3f queued "
            "with one sync" % (prog["read_back"], prog["queued"]))
        for name, rel, batch in LEGACY_CONFIGS:
            extra = dict(cfg["args"].get(name, {}))
            b = int(extra.get("batch_size", batch))
            stats, text, wall = _legacy_run(
                config_path=paths[name], job="time", use_gpu=use_gpu,
                config_args=dict(extra,
                                 num_samples=str(b * cfg["batches"])))
            for line in text.splitlines():
                log("  %s: %s" % (name, line))
            m = re.search(r"^Time: ([0-9.]+) ms/batch \(([0-9.]+) "
                          r"samples/sec\)$", text, re.M)
            check(m is not None, "phase 40: %s printed no Time line" % name)
            costs = stats["costs"]
            check(stats["batches"] == cfg["batches"] and stats["timed"] > 0
                  and all(math.isfinite(c) for c in costs),
                  "phase 40: %s trained %d batches, timed %d, costs %s"
                  % (name, stats["batches"], stats["timed"], costs))
            out[name] = dict(batch=b, ms_per_batch=float(m.group(1)),
                             samples_per_s=float(m.group(2)),
                             trainer_ms_unrounded=stats["ms_per_batch"],
                             timed=stats["timed"], wall_s=wall,
                             first_cost=costs[0], last_cost=costs[-1])
            log("  %s batch %d: %.3f ms/batch over %d timed batches, %.1f "
                "samples/s (the trainer's line), %.1f s for the whole "
                "run_config" % (name, b, stats["ms_per_batch"],
                                stats["timed"], stats["img_per_sec"], wall))
    finally:
        torch.backends.cudnn.benchmark = False

    # ResNet-50 through the legacy lowering beside phase 16's Fluid
    # program at the legacy config's batch and precision: the time job
    # over its program read back every step (the provider and the
    # feeder), that over the program queued (the per-step read-back),
    # that over phase 16's program, timed alike (the lowering)
    fl = phase_fluid_resnet(torch, fluid, resnet, warm=2, steps=cfg["steps"],
                            amp=False, place=place, cfg=cfg["fluid"])
    job = out["resnet"]["ms_per_batch"]
    out["resnet_fluid_program"] = dict(ms_per_step=fl["ms_per_step"],
                                       img_per_s=fl["img_per_s"])
    out["resnet_split"] = dict(
        job_over_fluid=job / fl["ms_per_step"],
        provider_feeder=job / prog["read_back"],
        read_back=prog["read_back"] / prog["queued"],
        lowering=prog["queued"] / fl["ms_per_step"])
    log("  ResNet-50 batch %d f32: legacy resnet.py %.3f ms/batch; its "
        "program alone %.3f (read back) / %.3f (queued); phase 16's Fluid "
        "program %.3f ms/step queued; ratios %s"
        % (out["resnet"]["batch"], job, prog["read_back"], prog["queued"],
           fl["ms_per_step"], json.dumps(out["resnet_split"])))

    tmp = tempfile.mkdtemp(prefix="phase40_")
    det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        small = paths["smallnet"]
        pargs = dict(cfg["parity"])
        pb = int(pargs.get("batch_size", 128))
        # one init: the port's startup on the CPU, saved
        topo, _cost, _st = _legacy_build(small, pargs)
        scope = fluid.Scope()
        with fluid.scope_guard(scope):
            fluid.Executor(fluid.CPUPlace()).run(topo.startup_program)
        save_checkpoint(scope, os.path.join(tmp, "init"), step=0)
        runs = {}
        for side, ug in (("card", use_gpu), ("cpu", False)):
            stats = _legacy_run(
                config_path=small, job="train",
                config_args=dict(pargs, num_samples=str(3 * pb)),
                init_model_path=os.path.join(tmp, "init"),
                save_dir=os.path.join(tmp, side), use_gpu=ug)[0]
            runs[side] = (stats["costs"], _legacy_saved(
                fluid, os.path.join(tmp, side, "pass-00000")))
        (cc, cs), (pc, ps) = runs["card"], runs["cpu"]
        cost_err = max(abs(a - b) / max(abs(b), 1e-12)
                       for a, b in zip(cc, pc))
        val_err = max(float(np.abs(cs[n] - ps[n]).max()
                            / max(np.abs(ps[n]).max(), 1e-12)) for n in ps)
        log("  smallnet card vs CPU, 3 batches of %d from one init: costs "
            "%s vs %s, max rel err %.3e; saved values max rel err %.3e"
            % (pb, cc, pc, cost_err, val_err))
        check(len(cc) == len(pc) == 3 and sorted(cs) == sorted(ps),
              "phase 40: the card and CPU runs differ in shape")
        check(cost_err <= 1e-4 and val_err <= 1e-4,
              "phase 40: smallnet card vs CPU beyond 1e-4 (%.3e, %.3e)"
              % (cost_err, val_err))
        out["smallnet_card_vs_cpu"] = dict(cost_rel_err=cost_err,
                                           saved_rel_err=val_err)

        # save_dir -> init_model_path on the card: the resumed pass is the
        # uninterrupted run's second pass
        rargs = dict(pargs, num_samples=str(4 * pb))
        full = _legacy_run(
            config_path=small, job="train", config_args=rargs,
            num_passes=2, save_dir=os.path.join(tmp, "resume"),
            use_gpu=use_gpu)[0]["costs"]
        resumed = _legacy_run(
            config_path=small, job="train", config_args=rargs,
            init_model_path=os.path.join(tmp, "resume", "pass-00000"),
            use_gpu=use_gpu)[0]["costs"]
        resume_err = max(abs(a - b) / max(abs(b), 1e-12)
                         for a, b in zip(resumed, full[4:]))
        log("  resume: uninterrupted pass 2 %s, resumed %s, max rel err "
            "%.3e" % (full[4:], resumed, resume_err))
        check(len(full) == 8 and len(resumed) == 4 and resume_err <= 1e-6,
              "phase 40: the resumed pass differs from the uninterrupted "
              "run's (%.3e)" % resume_err)
        out["resume_rel_err"] = resume_err
    finally:
        torch.backends.cudnn.deterministic = det
        shutil.rmtree(tmp, ignore_errors=True)
    return out


# --- phase 41: the elastic data plane ----------------------------------

# (a): ResNet-50 at phase 16's batch 64 in f32, fed from RecordShards in
# bench.py's record layout (bench.py:580: [label u16][uint8 3x224x224]);
# `batches` is the pass's length (warm-up and timed steps together)
DATA_PLANE = dict(batch=64, shape=[3, 224, 224], classes=1000, depth=50,
                  warm=2, steps=10, files=2, workers=2, prefetch=4, seed=7)
# (b): smallnet's config_args (its defaults: 32x32x3, batch 128), 3 batches
DATA_PLANE_SMALLNET = {}
# (c): two LeNet workers over one coordinator queue; record =
# [u32 id][u8 label][uint8 1x28x28]. A lease is held from the lease
# through the decode lookahead to the ack, which waits for the sentinel's
# promotion (promote_after checkpoints), so it must cover a restarted
# worker's first steps: ~8-10 s on the card machine, and past 8 s on a
# slower host, where an 8 s lease expired under its holder (LeaseLost,
# and records delivered again). The idle grace exceeds the lease, so a
# survivor outwaits a dead peer's requeue.
DRILL = dict(shards=2, chunks_per_shard=8, records_per_chunk=64, batch=32,
             seed=11, lease_s=20.0, idle_grace_s=25.0, promote_after=2,
             heartbeat_s=60.0, faults={"w0": "kill@5", "w1": "nanloss@7"},
             deadline_s=240.0)


def _rio_image_records(native, path, n, rng, shape, classes):
    """n records of bench.py's layout, [label u16][raw uint8 image],
    written with the native RecordWriter."""
    import struct

    size = int(np.prod(shape))
    with native.RecordWriter(path) as w:
        for _ in range(n):
            label = int(rng.randint(0, classes))
            img = rng.randint(0, 256, size, dtype=np.uint8)
            w.write(struct.pack("<H", label) + img.tobytes())


def _image_record_decoder(shape):
    def decode(rec):
        label = int.from_bytes(rec[:2], "little")
        img = np.frombuffer(rec, np.uint8, offset=2).reshape(shape)
        return img, np.array([label], np.int64)

    return decode


def uint8_image_program(fluid, model, shape, classes, amp=False):
    """fluid_image_program with bench.py's uint8 input
    (`_build_image_workload(uint8_input=True)`, bench.py:214-220): uint8
    images cross to the card and are cast and scaled by 1/255 there."""
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        raw = fluid.layers.data(name="image", shape=shape, dtype="uint8")
        image = fluid.layers.scale(x=fluid.layers.cast(raw, "float32"),
                                   scale=1.0 / 255.0)
        label = fluid.layers.data(name="label", shape=[1], dtype="int64")
        predict = model(image, classes)
        avg = fluid.layers.mean(
            x=fluid.layers.cross_entropy(input=predict, label=label))
        fluid.optimizer.Momentum(learning_rate=0.01, momentum=0.9).minimize(
            avg)
    main.amp = amp
    return main, startup, avg


def _data_plane_resnet(torch, fluid, resnet, tmp, place, cfg, fluid16_ms):
    """(a) of phase 41; returns its record."""
    from paddle_tpu_torch import native
    from paddle_tpu_torch.data import DataLoader, DataMetrics, \
        ShardedDataset, from_recordio

    b, n = cfg["batch"], cfg["warm"] + cfg["steps"]
    per_file = b * n // cfg["files"]
    rng = np.random.RandomState(cfg["seed"])
    t0 = time.monotonic()
    shards = []
    for k in range(cfg["files"]):
        rio = os.path.join(tmp, "images%d.rio" % k)
        _rio_image_records(native, rio, per_file, rng, cfg["shape"],
                           cfg["classes"])
        shards.append(os.path.join(tmp, "images%d.rs" % k))
        from_recordio(rio, shards[-1], records_per_chunk=b)
        os.remove(rio)
    write_s = time.monotonic() - t0
    decode = _image_record_decoder(cfg["shape"])
    ds = ShardedDataset(shards, decode_fn=decode, seed=cfg["seed"])
    check(ds.num_records == b * n, "phase 41: %d records in the shards"
          % ds.num_records)
    # the delivery oracle: the synchronous loader's stream, on the host
    ref = DataLoader(ds, b, num_workers=0)
    ref_labels, ref_sums, first = [], [], None
    for img, lab in ref:
        first = img if first is None else first
        ref_labels.append(lab)
        ref_sums.append(int(img.sum(dtype=np.int64)))
    ref.close()
    ref_labels = np.concatenate(ref_labels)

    main, startup, avg = uint8_image_program(
        fluid, lambda x, c: resnet.resnet_imagenet(x, c, depth=cfg["depth"]),
        cfg["shape"], cfg["classes"])
    scope = fluid.Scope()
    torch.backends.cudnn.benchmark = True
    try:
        with fluid.scope_guard(scope):
            exe = fluid.Executor(place or fluid.CUDAPlace(0))
            dev = exe.device
            exe.run(startup)
            # the same program on one fixed batch already on the device
            fixed = {"image": torch.from_numpy(first).to(dev),
                     "label": torch.from_numpy(ref_labels[:b]).to(dev)}
            for _ in range(cfg["warm"]):
                exe.run(main, feed=fixed, fetch_list=[avg],
                        return_numpy=False)
            _sync(torch, dev.type)
            t0 = time.monotonic()
            for _ in range(cfg["steps"]):
                exe.run(main, feed=fixed, fetch_list=[avg],
                        return_numpy=False)
            _sync(torch, dev.type)
            fixed_ms = (time.monotonic() - t0) / cfg["steps"] * 1e3
            del fixed

            loader = DataLoader(ds, b, num_workers=cfg["workers"],
                                prefetch_batches=cfg["prefetch"],
                                device_put=True, place=place)
            it = iter(loader)
            losses, labels, sums, first_dev = [], [], [], None
            t0 = time.monotonic()
            for k in range(n):
                if k == cfg["warm"]:
                    _sync(torch, dev.type)
                    loader.metrics = DataMetrics()  # the timed steps only
                    warm_s, t0 = time.monotonic() - t0, time.monotonic()
                img, lab = next(it)
                check(img.device.type == dev.type and img.dtype ==
                      torch.uint8, "phase 41: a batch arrived as %s on %s"
                      % (img.dtype, img.device))
                first_dev = img if first_dev is None else first_dev
                losses.append(exe.run(main, feed={"image": img,
                                                  "label": lab},
                                      fetch_list=[avg],
                                      return_numpy=False)[0])
                labels.append(lab)
                sums.append(img.sum(dtype=torch.int64))
            _sync(torch, dev.type)
            wall = time.monotonic() - t0
            check(next(it, None) is None, "phase 41: the loader delivered "
                  "more than the pass")
            rep = loader.metrics.report()
            loader.close()
            got_labels = torch.cat(labels).cpu().numpy()
            got_sums = [int(s) for s in torch.stack(sums).cpu()]
            first_equal = bool(np.array_equal(first_dev.cpu().numpy(),
                                              first))
    finally:
        torch.backends.cudnn.benchmark = False
    losses = [float(x.reshape(())) for x in losses]
    check(all(math.isfinite(x) for x in losses),
          "phase 41: a ResNet-50 loss from shards is not finite: %s" % losses)
    check(np.array_equal(got_labels, ref_labels),
          "phase 41: the delivered label stream differs from the "
          "synchronous loader's")
    check(got_sums == ref_sums and first_equal,
          "phase 41: uploaded pixels differ from the host's batches "
          "(sums %s vs %s, first batch equal %s)"
          % (got_sums[:4], ref_sums[:4], first_equal))
    ms = wall / cfg["steps"] * 1e3
    out = dict(batch=b, records=ds.num_records, chunks=ds.num_chunks,
               write_s=write_s, ms_per_step=ms, img_per_s=b / ms * 1e3,
               wait_fraction=rep["wait_fraction"],
               mean_wait_ms=(rep["mean_wait_s"] or 0.0) * 1e3,
               warm_s=warm_s,
               fixed_batch_ms=fixed_ms, loader_over_fixed=ms / fixed_ms,
               fluid16_ms=fluid16_ms,
               over_phase16=(ms / fluid16_ms if fluid16_ms else None),
               losses=losses)
    log("  (a) ResNet-50 b%d f32 from %d shards (%d chunks, written in "
        "%.1f s): %.3f ms/step, %.1f img/s, wait_fraction %s (mean wait "
        "%.3f ms); the same uint8 program on a fixed batch %.3f ms/step "
        "(loader / fixed %.4f); phase 16's f32 program at b%d %s "
        "(ratio %s); labels and pixels equal to the synchronous pass"
        % (b, len(shards), ds.num_chunks, write_s, ms, out["img_per_s"],
           rep["wait_fraction"], out["mean_wait_ms"], fixed_ms,
           out["loader_over_fixed"], b,
           "%.3f ms/step" % fluid16_ms if fluid16_ms else "not measured",
           "%.4f" % out["over_phase16"] if fluid16_ms else "-"))
    del scope, exe
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
    return out


def _data_plane_smallnet(torch, fluid, tmp, use_gpu, args):
    """(b) of phase 41: smallnet through run_config(recordio=...) on the
    device and on the CPU from one init."""
    import glob
    import pickle

    from paddle_tpu_torch import native
    from paddle_tpu_torch.distributed import save_checkpoint

    small = _here("benchmarks/paddle/image/smallnet_mnist_cifar.py")
    topo, _cost, st = _legacy_build(small, args)
    b = int(st["batch_size"])
    rng = np.random.RandomState(3)
    for k in range(2):  # 3 batches over two files, found by a glob
        with native.RecordWriter(os.path.join(tmp, "cifar-%d.rio" % k)) as w:
            for _ in range(3 * b // 2 + k * (3 * b % 2)):
                x = rng.rand(3 * 32 * 32).astype(np.float32)
                w.write(pickle.dumps((x, int(rng.randint(0, 10)))))
    rio = [os.path.join(tmp, "cifar-*.rio")]
    check(len(glob.glob(rio[0])) == 2, "phase 41: the record files")
    scope = fluid.Scope()
    with fluid.scope_guard(scope):
        fluid.Executor(fluid.CPUPlace()).run(topo.startup_program)
    init = os.path.join(tmp, "smallnet_init")
    save_checkpoint(scope, init, step=0)
    det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        costs = {}
        for side, ug in (("card", use_gpu), ("cpu", False)):
            costs[side] = _legacy_run(config_path=small, job="train",
                                      config_args=dict(args), recordio=rio,
                                      init_model_path=init,
                                      use_gpu=ug)[0]["costs"]
    finally:
        torch.backends.cudnn.deterministic = det
    cc, pc = costs["card"], costs["cpu"]
    err = max(abs(a - c) / max(abs(c), 1e-12) for a, c in zip(cc, pc))
    log("  (b) smallnet b%d from record files, card vs CPU from one init: "
        "costs %s vs %s, max rel err %.3e" % (b, cc, pc, err))
    check(len(cc) == len(pc) == 3 and err <= 1e-4,
          "phase 41: smallnet from record files, card vs CPU beyond 1e-4 "
          "(%d / %d batches, %.3e)" % (len(cc), len(pc), err))
    return dict(batch=b, batches=len(cc), cost_rel_err=err, costs_card=cc)


def _drill_decode(rec):
    rid = int.from_bytes(rec[:4], "little")
    img = np.frombuffer(rec, np.uint8, offset=5).reshape(1, 28, 28)
    return rid, img.astype(np.float32) / 255.0, np.array([rec[4]], np.int64)


def _drill_collate(items):
    """(images, labels, ids): arrays for the card, the ids a host list."""
    return (np.stack([it[1] for it in items]),
            np.stack([it[2] for it in items]), [it[0] for it in items])


def _drill_shards(data, sdir, cfg):
    rng = np.random.RandomState(cfg["seed"])
    paths, rid = [], 0
    for s in range(cfg["shards"]):
        p = os.path.join(sdir, "mnist%02d.rs" % s)
        with data.ShardWriter(p, records_per_chunk=cfg[
                "records_per_chunk"]) as w:
            for _ in range(cfg["chunks_per_shard"] *
                           cfg["records_per_chunk"]):
                img = rng.randint(0, 256, 28 * 28, dtype=np.uint8)
                w.write(rid.to_bytes(4, "little")
                        + bytes([int(rng.randint(0, 10))]) + img.tobytes())
                rid += 1
        paths.append(p)
    return paths, rid


def _flush_acks(client, cursor):
    """Send the coordinator the acks a checkpointed loader cursor holds:
    what the known-good checkpoint delivered becomes durable there, and
    nothing newer (a sentinel rollback may still undo it)."""
    pending = (cursor or {}).get("pending") or {}
    for tid, lease in pending.get("finish") or []:
        client.task_finished(tid, lease=lease)
    prog = pending.get("progress")
    if prog:
        client.task_progress(prog["task_id"], prog["offset"],
                             lease=prog.get("lease"))


def data_worker(out_path, ckpt_dir, addr, shard_dir):
    """One of phase 41(c)'s supervised workers (`chip_smoke.py
    --data-worker OUT CKPT ADDR SHARDS`): LeNet trained on the card (on
    the CPU when DRILL_PLACE=cpu, for a rehearsal) from chunks leased
    through CoordinatedChunkSource, batches uploaded by the loader, the
    training sentinel over the loss the loop reads back each step, a
    checkpoint each step with the loader cursor and the detector in it.
    The coordinator hears of a chunk's records only once a checkpoint
    that holds them is known-good (`_flush_acks`), so a rollback never
    loses records the coordinator counts as delivered. Exits 75 on a
    sentinel trip."""
    import glob

    import torch

    from paddle_tpu_torch import fluid
    from paddle_tpu_torch.data import (CoordinatedChunkSource, DataLoader,
                                       ShardedDataset)
    from paddle_tpu_torch.distributed import (RemoteCoordinator,
                                              checkpoint as ckpt,
                                              fault_injection as fi,
                                              sentinel as sent_mod)
    from paddle_tpu_torch.models import lenet

    cfg = DRILL
    wid = os.environ.get("PADDLE_WORKER_ID", "w?")
    reason = os.environ.get("PADDLE_RESTART_REASON", "none")
    place = (fluid.CPUPlace() if os.environ.get("DRILL_PLACE") == "cpu"
             else fluid.CUDAPlace(0))
    client = RemoteCoordinator(addr, retry_deadline_s=30.0,
                               backoff_base_s=0.05)
    ds = ShardedDataset(sorted(glob.glob(os.path.join(shard_dir, "*.rs"))),
                        decode_fn=_drill_decode, seed=cfg["seed"])
    loader = DataLoader(
        ds, cfg["batch"], num_workers=2, collate_fn=_drill_collate,
        source=CoordinatedChunkSource(client,
                                      idle_grace_s=cfg["idle_grace_s"],
                                      poll_s=0.1),
        device_put=True, place=place, auto_commit=False)
    main, startup, avg = fluid_image_program(fluid, lenet.lenet,
                                             [1, 28, 28], 10, amp=False)
    scope = fluid.Scope()
    exe = fluid.Executor(place)
    with fluid.scope_guard(scope):
        exe.run(startup)
    detector = sent_mod.DivergenceDetector(hysteresis=1, warmup=2)
    sent = sent_mod.TrainingSentinel(ckpt_dir, dataset=ds,
                                     promote_after=cfg["promote_after"],
                                     detector=detector)
    stateful = {"loader": loader, "detector": detector}
    meta = ckpt.resume_or_init(scope, ckpt_dir, stateful=stateful)
    if meta is not None:
        step = resumed_from = int(meta["extra"]["step"])
        history = list(meta["extra"]["history"])
        sent.align(step)
        loader.commit()  # the resumed checkpoint's acks are durable
    else:
        step, resumed_from, history = 0, None, []
    # registered once set up; both workers up before either leases
    client.register_worker(wid, meta={"restart_reason": reason})
    while len(client.membership()) < len(cfg["faults"]):
        time.sleep(0.05)
    injector = fi.default_injector()
    flushed = sent.known_good_step
    first_step_at, losses = None, []
    with fluid.scope_guard(scope):
        for img, label, ids in loader:
            injector.tick()
            client.heartbeat(wid, step=step)
            loss = exe.run(main, feed={"image": img, "label": label},
                           fetch_list=[avg], return_numpy=False)[0]
            # the loop's one read of the step; the sentinel takes it
            loss = injector.poison_loss(float(loss.reshape(())))
            first_step_at = first_step_at or time.time()
            step += 1
            losses.append(loss)
            decision = sent.observe(step, loss, cursor=loader.state_dict())
            if decision is not None:
                client.heartbeat(wid, step=step)
                client.close()
                loader.close()
                return (sent_mod.SENTINEL_EXIT_CODE
                        if decision["action"] != "abandon" else 1)
            history.extend(ids)
            ckpt.save_checkpoint(scope, ckpt_dir, step=step,
                                 extra={"step": step, "history": history},
                                 stateful=stateful, keep_last=4,
                                 protect=sent.known_good_step)
            sent.on_checkpoint(step, cursor=loader.state_dict())
            if sent.known_good_step != flushed:
                _flush_acks(client, sent.known_good_cursor)
                flushed = sent.known_good_step
    loader.commit()  # the pass is over: every delivered record is final
    client.heartbeat(wid, step=step)
    client.close()
    loader.close()
    tmp = out_path + ".tmp"
    with open(tmp, "w") as f:
        json.dump({"worker": wid, "resumed_from": resumed_from,
                   "restart_reason": reason, "steps_done": step,
                   "history": history, "known_good": sent.known_good_step,
                   "trips": sent.trips, "first_step_at": first_step_at,
                   "losses": losses, "device": str(exe.device),
                   "restart_count": int(os.environ.get(
                       "PADDLE_RESTART_COUNT", "0"))}, f)
    os.replace(tmp, out_path)
    return 0


def _data_plane_drill(tmp, cfg=DRILL, worker_argv=None, env_extra=None):
    """(c) of phase 41: a CoordinatorServer and a Supervisor over two
    data_worker processes, one killed (kill@N) and one whose loss turns
    NaN (nanloss@M)."""
    from paddle_tpu_torch import data
    from paddle_tpu_torch.distributed import (Coordinator,
                                              CoordinatorServer, Supervisor)

    sdir = os.path.join(tmp, "drill_shards")
    os.makedirs(sdir)
    paths, n_records = _drill_shards(data, sdir, cfg)
    ds = data.ShardedDataset(paths, seed=cfg["seed"])
    coord = Coordinator(timeout_s=cfg["lease_s"], failure_max=10,
                        heartbeat_timeout_s=cfg["heartbeat_s"])
    coord.set_dataset(ds.payloads())
    server = CoordinatorServer(coord).start()
    here = os.path.abspath(__file__)
    argv = worker_argv or [sys.executable, here, "--data-worker"]

    def files(wid):
        return (os.path.join(tmp, "drill_%s.json" % wid),
                os.path.join(tmp, "drill_ckpt_%s" % wid))

    def env_for(wid):
        env = dict(os.environ, PADDLE_FAULT=cfg["faults"][wid])
        env.update(env_extra or {})
        return env

    sup = Supervisor(lambda wid: argv + [*files(wid), server.address, sdir],
                     sorted(cfg["faults"]), env_for=env_for,
                     coordinator=coord, min_uptime_s=2.0,
                     ckpt_dir_for=lambda wid: files(wid)[1],
                     ckpt_keep_last=4)
    t0 = time.time()
    try:
        report = sup.run(deadline_s=cfg["deadline_s"])
    finally:
        server.stop()
    wall = time.time() - t0
    workers = report["workers"]
    log("  (c) supervisor: %s in %.1f s" % (json.dumps(
        {w: {k: v[k] for k in ("restarts", "restart_reasons", "exit_codes",
                               "abandoned", "done")}
         for w, v in workers.items()}), wall))
    check(report["ok"], "phase 41: the drill did not drain: %s"
          % json.dumps(report)[:2000])
    recs = {w: json.load(open(files(w)[0])) for w in sorted(cfg["faults"])}
    union = [i for r in recs.values() for i in r["history"]]
    check(sorted(union) == list(range(n_records)),
          "phase 41: the delivered multiset is not the dataset: %d "
          "delivered, %d distinct, %d records" % (len(union), len(set(union)),
                                                 n_records))
    check(len(coord.done) == ds.num_chunks and not coord.pending
          and not coord.todo, "phase 41: the coordinator's queue did not "
          "drain (%d done, %d pending, %d todo)"
          % (len(coord.done), len(coord.pending), len(coord.todo)))
    check(workers["w0"]["restart_reasons"] == ["crash"]
          and workers["w0"]["exit_codes"][0] == -9,
          "phase 41: w0's restarts read %s" % workers["w0"])
    check(workers["w1"]["restart_reasons"] == ["sentinel_rollback"]
          and workers["w1"]["exit_codes"][0] == 75,
          "phase 41: w1's restarts read %s" % workers["w1"])
    trip = recs["w1"]["trips"][-1] if recs["w1"]["trips"] else None
    check(trip is not None and trip["verdict"] == "nonfinite"
          and trip["action"] == "rollback"
          and trip["rollback_to"] is not None
          and recs["w1"]["resumed_from"] == trip["rollback_to"],
          "phase 41: w1 was not rolled back to its known-good step "
          "(trip %s, resumed from %s)" % (trip, recs["w1"]["resumed_from"]))
    check(recs["w0"]["restart_reason"] == "crash"
          and recs["w1"]["restart_reason"] == "sentinel_rollback",
          "phase 41: the replacements were told %s / %s"
          % (recs["w0"]["restart_reason"], recs["w1"]["restart_reason"]))
    check(all(math.isfinite(x) for r in recs.values() for x in r["losses"]),
          "phase 41: a replacement's loss is not finite")
    deaths = {e["worker"]: e["t"] for e in report["events"]
              if e["kind"] in ("crash", "sentinel_rollback")}
    recover = {w: recs[w]["first_step_at"] - deaths[w] for w in deaths
               if recs[w]["first_step_at"]}
    out = dict(records=n_records, chunks=ds.num_chunks, wall_s=wall,
               steps={w: r["steps_done"] for w, r in recs.items()},
               delivered={w: len(r["history"]) for w, r in recs.items()},
               resumed_from={w: r["resumed_from"] for w, r in recs.items()},
               rollback_to=trip["rollback_to"], trip_step=trip["step"],
               restart_reasons={w: v["restart_reasons"]
                                for w, v in workers.items()},
               recover_s=recover,
               devices={w: r["device"] for w, r in recs.items()})
    log("  (c) %d records over %d chunks delivered exactly once (%s); w0 "
        "killed, resumed from step %s; w1 tripped at step %d, rolled back "
        "to known-good step %d; death to the replacement's first step %s s"
        % (n_records, ds.num_chunks, out["delivered"],
           out["resumed_from"]["w0"], trip["step"], trip["rollback_to"],
           {w: round(s, 1) for w, s in recover.items()}))
    return out


def phase_data_plane(torch, fluid, resnet, card="cpu", place=None,
                     fluid16_ms=None, cfg=DATA_PLANE,
                     smallnet_args=DATA_PLANE_SMALLNET, drill=DRILL,
                     drill_argv=None, drill_env=None):
    """Phase 41 (see the module docstring); `place` (a CPUPlace), the
    configurations and `drill_argv` / `drill_env` shrink it for a
    rehearsal on the CPU."""
    import shutil
    import tempfile

    tmp = tempfile.mkdtemp(prefix="phase41_")
    out = {"card": card}
    try:
        t0 = time.monotonic()
        out["resnet_from_shards"] = _data_plane_resnet(
            torch, fluid, resnet, tmp, place, cfg, fluid16_ms)
        t1 = time.monotonic()
        out["smallnet_recordio"] = _data_plane_smallnet(
            torch, fluid, tmp, place is None, smallnet_args)
        t2 = time.monotonic()
        out["drill"] = _data_plane_drill(tmp, drill, worker_argv=drill_argv,
                                         env_extra=drill_env)
        out["seconds"] = dict(resnet=t1 - t0, smallnet=t2 - t1,
                              drill=time.monotonic() - t2)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return out


# ---------------------------------------------------------------------
# phase 42: the serving fleet at full width
# ---------------------------------------------------------------------

# phase 42's settings: replicas of the fleet runs, how long the caller
# waits for a verdict, the f32 drill's request count, the rollout's
# checkpoint step, perturbation and canary period, the front door's
# open-loop runs (bench.py:3413-3620's serving_frontdoor: two tenants,
# every request streamed, 24-token prompts, 32 new tokens) and the
# batch lane's LeNet batch (the book's MNIST LeNet)
FLEET = dict(replicas=3, heartbeat_s=300.0, budget_s=600.0, step_s=0.004,
             f32_requests=16, quant_requests=8, quant_max_new=32,
             rollout_requests=32, rollout_step=1,
             perturb=0.01,
             canary_interval_s=0.5,
             frontdoor=dict(replicas=2, n_warm=16, prompt_len=24,
                            max_new=32, duration_s=5.0,
                            rate_factors=(0.25, 1.0), settle_s=120.0,
                            weights=(2.0, 1.0)),
             batch=dict(batch=64, jobs=4, lm_requests=8))


def _fleet(ServingFleet, params, cfg, n, journal, dev, engine=ENGINE,
           **kw):
    """A fleet of `n` replicas of `engine` on `dev` (the card unless a
    rehearsal names the CPU), journaling to `journal` with no compaction
    (the whole history stays for the one-terminal-per-rid check)."""
    return ServingFleet(params, cfg, n_replicas=n, journal_path=journal,
                        heartbeat_timeout_s=FLEET["heartbeat_s"],
                        max_pending=1 << 12, affinity=True,
                        journal_compact_every=None,
                        engine_kw=dict(engine, device=dev), **kw)


def _fleet_drive(fleet, reqs, arrive, kill_after=None, during=None,
                 during_after=0, submit_kw=None):
    """Submit `reqs` [(prompt, max_new)] at their arrival steps
    (`FLEET["step_s"]` of wall time a step) and wait for every verdict.
    After `kill_after` submissions, the replica holding the most work
    is killed (kill_replica) once some of its work has emitted tokens
    (so the survivors resume from the journal); after `during_after`,
    `during()` is called once, if given. `submit_kw(i)` adds submit arguments. Returns (handles, wall
    s, the killed replica's index or None)."""
    hs, killed, started = [], None, False
    t0 = time.monotonic()
    i = step = 0
    while i < len(reqs):
        while i < len(reqs) and arrive[i] <= step:
            prompt, n = reqs[i]
            kw = dict(publish_len=POISSON["header"])
            kw.update(submit_kw(i) if submit_kw else {})
            hs.append(fleet.submit(prompt, n, **kw))
            i += 1
        if kill_after is not None and killed is None and i >= kill_after:
            killed = _kill_busiest(fleet)
        if during is not None and not started and i >= during_after:
            during()
            started = True
        time.sleep(FLEET["step_s"])
        step += 1
    while kill_after is not None and killed is None \
            and not all(h.done for h in hs):
        killed = _kill_busiest(fleet)
        time.sleep(FLEET["step_s"])
    for h in hs:
        h.result(timeout=FLEET["budget_s"])
    return hs, time.monotonic() - t0, killed


def _kill_busiest(fleet):
    """Kill the replica holding the most started in-flight work; None
    (and nothing killed) while no replica holds any."""
    killed = fleet.busiest_replica()
    if killed is not None:
        fleet.kill_replica(killed)
    return killed


def _journal_records(path):
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


def _check_fleet_run(label, fleet, hs, journal, vocab, verify_journal,
                     format_diag):
    """The bars every fleet run of phase 42 meets: every request done
    within its budget with tokens in the vocabulary, nothing lost and
    nothing answered twice, and the journal clean through the port's
    DFA with every rid closed. Returns the fleet's stats."""
    st = fleet.stats()
    for h in hs:
        check(h.done and h.error is None and h.tokens is not None
              and (h.batch_fn is not None
                   or len(h.tokens) == h.spec["max_new_tokens"]),
              "phase 42 %s: request %d did not complete" % (label, h.rid))
        check(all(0 <= t < vocab for t in h.tokens),
              "phase 42 %s: request %d emitted a token outside the vocab"
              % (label, h.rid))
    check(st["lost"] == 0 and st["duplicate_refused"] == 0
          and st["completed"] >= len(hs),
          "phase 42 %s: lost %d, duplicates refused %d, completed %d of %d"
          % (label, st["lost"], st["duplicate_refused"], st["completed"],
             len(hs)))
    fleet.close()
    terminals = {}
    for r in _journal_records(journal):
        if r["kind"] in ("done", "rejected", "expired", "cancelled"):
            terminals[r["rid"]] = terminals.get(r["rid"], 0) + 1
    check(all(terminals.get(h.rid) == 1 for h in hs)
          and all(n == 1 for n in terminals.values()),
          "phase 42 %s: a request has no terminal record or several"
          % label)
    diags = verify_journal(journal, expect_closed=True)
    check(not diags, "phase 42 %s: the journal fails the DFA:\n  %s"
          % (label, "\n  ".join(format_diag(d) for d in diags)))
    return st


def _engine_counts(fleet):
    """(decode steps, prefill chunks) of the engines the fleet holds,
    read after close through `engine_counts()`."""
    counts = [c for c in fleet.engine_counts() if c is not None]
    return (sum(c["decode_steps"] for c in counts),
            sum(c["prefill_chunks"] for c in counts))


def _fleet_serve(torch, tpa, ServingFleet, params, cfg, n, reqs, arrive,
                 tmp, label, verify_journal, format_diag, dev="cuda",
                 kill=False, exact=True, **kw):
    """One bf16 fleet run over the trace with the paged counters zeroed
    just before the first submit and read just after the last verdict."""
    journal = os.path.join(tmp, label + ".jsonl")
    fleet = _fleet(ServingFleet, params, cfg, n, journal, dev, **kw)
    _sync(torch, dev)
    zero_launches(tpa)
    hs, wall, killed = _fleet_drive(
        fleet, reqs, arrive, kill_after=len(reqs) // 3 if kill else None)
    _sync(torch, dev)
    launches = read_launches(tpa)
    st = _check_fleet_run(label, fleet, hs, journal, cfg.vocab,
                          verify_journal, format_diag)
    dec, pre = _engine_counts(fleet)
    toks = sum(len(h.tokens) for h in hs)
    ttft = sorted(h.ttft_s for h in hs if h.ttft_s is not None)
    out = dict(replicas=n, requests=len(hs), tokens=toks, wall_s=wall,
               tokens_per_s=toks / wall, launches=launches,
               decode_steps=dec, prefill_chunks=pre,
               failovers=st["failovers"], resubmitted=st["resubmitted"],
               migrations=st["migrations"],
               handoff_imports=st["handoff_imports"],
               tokens_recomputed_at_migration=st[
                   "tokens_recomputed_at_migration"],
               prefix_hit_rate=st["prefix_hit_rate"],
               ttft_p50_s=ttft[len(ttft) // 2] if ttft else None,
               killed=killed)
    if dev == "cuda":
        if exact:
            check(launches["decode"] == cfg.layers * dec and dec > 0
                  and launches["prefill"] == cfg.layers * pre and pre > 0,
                  "phase 42 %s: launches %s != layers x (decode steps "
                  "%d, prefill chunks %d)" % (label, launches, dec, pre))
        else:
            check(launches["decode"] >= cfg.layers * dec
                  and launches["prefill"] >= cfg.layers * pre,
                  "phase 42 %s: launches %s below layers x the reported "
                  "decode steps %d and prefill chunks %d"
                  % (label, launches, dec, pre))
    log("  (a) %s: %d requests, %d tokens in %.3f s: %.1f tokens/s; "
        "launches %s (decode steps %d, prefill chunks %d); failovers %d, "
        "migrations %d, handoff imports %d, tokens recomputed at "
        "migration %d" % (label, len(hs), toks, wall, toks / wall,
                          launches, dec, pre, st["failovers"],
                          st["migrations"], st["handoff_imports"],
                          st["tokens_recomputed_at_migration"]))
    return out, [list(h.tokens) for h in hs]


def _fleet_f32_drill(torch, T, ServingEngine, ServingFleet, params, cfg,
                     tmp, verify_journal, format_diag, dev="cuda"):
    """(a'): the trace's first requests, every third sampled, through one
    f32 engine and through a 3-replica f32 fleet that loses a replica
    holding work: the tokens are equal, request for request."""
    p32 = _tree_map(lambda t: t.float(), params)
    cfg32 = T.TransformerConfig(vocab=cfg.vocab, dim=cfg.dim,
                                heads=cfg.heads, layers=cfg.layers,
                                max_len=cfg.max_len)
    reqs, arrive = poisson_trace(cfg.vocab)
    n = FLEET["f32_requests"]
    reqs, arrive = reqs[:n], arrive[:n]

    def kw(i):
        return dict(temperature=0.8 if i % 3 == 1 else 0.0, seed=500 + i)

    eng = ServingEngine(p32, cfg32, device=dev, **ENGINE)
    ref = []
    for i, (prompt, m) in enumerate(reqs):
        ref.append(eng.submit(prompt, m, publish_len=POISSON["header"],
                              **kw(i)))
    eng.run()
    ref = [list(h.tokens) for h in ref]
    del eng
    journal = os.path.join(tmp, "f32_kill.jsonl")
    fleet = _fleet(ServingFleet, p32, cfg32, FLEET["replicas"], journal,
                   dev)
    hs, wall, killed = _fleet_drive(fleet, reqs, arrive,
                                    kill_after=n // 3, submit_kw=kw)
    st = _check_fleet_run("(a') f32 kill", fleet, hs, journal, cfg.vocab,
                          verify_journal, format_diag)
    got = [list(h.tokens) for h in hs]
    bad = [i for i, (a, b) in enumerate(zip(got, ref)) if a != b]
    check(not bad, "phase 42 (a'): f32 fleet tokens differ from one f32 "
          "engine for requests %s" % bad)
    check(st["failovers"] == 1, "phase 42 (a'): %d failovers, not 1"
          % st["failovers"])
    log("  (a') f32, %d requests (%d sampled), 3 replicas, replica %s "
        "killed: tokens equal one f32 engine's for every request (%d "
        "tokens); resubmitted %d, resumed tokens %d"
        % (n, sum(1 for i in range(n) if i % 3 == 1), killed,
           sum(len(g) for g in got), st["resubmitted"],
           st["resumed_tokens"]))
    return dict(requests=n, tokens=sum(len(g) for g in got), wall_s=wall,
                failovers=st["failovers"], resubmitted=st["resubmitted"],
                resumed_tokens=st["resumed_tokens"], killed=killed)


def _canary_golden(ServingEngine, params, cfg, prompt, n, dev):
    """A canary's known answer for one weight set: the greedy tokens of
    one engine of the fleet's configuration on the canary prompt."""
    eng = ServingEngine(params, cfg, device=dev, **ENGINE)
    h = eng.submit(np.asarray(prompt, np.int32), n)
    eng.run()
    return [int(t) for t in h.tokens]


def _fleet_rollout(torch, T, ServingEngine, ServingFleet, save_weights,
                   params, cfg, tmp, verify_journal, format_diag,
                   dev="cuda"):
    """(b): roll a 3-replica bf16 fleet, under load and with canaries on,
    onto a second weight set written by save_weights: the rollout runs
    in a thread once a third of the trace is submitted, and the rest of
    the trace waits for it, so both versions answer requests."""
    from paddle_tpu_torch.serving.integrity import CANARY_PROMPT

    g = torch.Generator(device=params["embed"].device).manual_seed(1)
    params2 = _tree_map(lambda t: (t.float() + FLEET["perturb"] * torch.randn(
        t.shape, generator=g, device=t.device)).to(t.dtype), params)
    ckpt = os.path.join(tmp, "weights")
    step = FLEET["rollout_step"]
    save_weights(params2, ckpt, step)
    cmax = 4
    gold1 = _canary_golden(ServingEngine, params, cfg, CANARY_PROMPT, cmax,
                           dev)
    gold2 = _canary_golden(ServingEngine, params2, cfg, CANARY_PROMPT, cmax,
                           dev)
    p = torch.tensor([list(CANARY_PROMPT)], device=params["embed"].device)
    gen1 = T.generate(params, p, cfg, cmax)[0, len(CANARY_PROMPT):].tolist()
    reqs, arrive = poisson_trace(cfg.vocab, seed=2)
    reqs = reqs[:FLEET["rollout_requests"]]
    arrive = arrive[:FLEET["rollout_requests"]]
    journal = os.path.join(tmp, "rollout.jsonl")
    fleet = _fleet(ServingFleet, params, cfg, FLEET["replicas"], journal,
                   dev, ckpt_dir=ckpt, rollout_policy="finish",
                   canary_interval_s=FLEET["canary_interval_s"],
                   canary_max_new=cmax, canary_golden=gold1)
    box = {}

    def roll():
        try:
            box["out"] = fleet.roll_weights(step, canary_golden=gold2,
                                            timeout=FLEET["budget_s"])
        except BaseException as e:  # noqa: BLE001 - re-raised below
            box["err"] = e

    import threading

    roller = threading.Thread(target=roll, name="phase42-rollout")
    def during():
        roller.start()
        roller.join(timeout=FLEET["budget_s"])

    hs, wall, _ = _fleet_drive(fleet, reqs, arrive, during=during,
                               during_after=len(reqs) // 3)
    roller.join(timeout=FLEET["budget_s"])
    check(not roller.is_alive() and "err" not in box,
          "phase 42 (b): roll_weights failed: %r" % (box.get("err"),))
    served = fleet.served_weights()
    st = _check_fleet_run("(b) rollout", fleet, hs, journal, cfg.vocab,
                          verify_journal, format_diag)
    leaves2 = T._leaves(params2)
    for name, version, p in served:
        got = T._leaves(p)
        check(version == step and len(got) == len(leaves2)
              and all(a.dtype == torch.bfloat16 and a.device.type == "cuda"
                      and torch.equal(a, b) for a, b in zip(got, leaves2))
              if dev == "cuda" else
              version == step and all(
                  torch.equal(a, b) for a, b in zip(got, leaves2)),
              "phase 42 (b): replica %s does not hold the second weight "
              "set in bf16 on the card" % name)
    last_assign, versions = {}, {}
    for r in _journal_records(journal):
        if r["kind"] == "assign":
            last_assign[r["rid"]] = r.get("weights_version")
        elif r["kind"] == "done":
            versions[r["rid"]] = (r.get("weights_version"),
                                  last_assign.get(r["rid"]))
    check(all(a == b for a, b in versions.values()),
          "phase 42 (b): a done's weights_version differs from its last "
          "assignment's")
    by_version = {}
    for v, _ in versions.values():
        by_version[v] = by_version.get(v, 0) + 1
    check(st["integrity_trips"] == 0 and st["canary_mismatches"] == 0
          and st["canaries_ok"] >= 1 and st["rollouts_completed"] == 1
          and by_version.get(0) and by_version.get(step),
          "phase 42 (b): integrity trips %d, canary mismatches %d, "
          "canaries ok %d, rollouts %d, dones by version %s"
          % (st["integrity_trips"], st["canary_mismatches"],
             st["canaries_ok"], st["rollouts_completed"], by_version))
    log("  (b) rolled 3 replicas to version %d under load in the %.3f s "
        "run: dones by version %s; canaries sent %d, ok %d, trips 0; "
        "every replica holds the second set bit for bit in bf16; the "
        "canary's engine golden %s, generate()'s %s"
        % (step, wall, by_version, st["canaries_sent"], st["canaries_ok"],
           gold1, gen1))
    return dict(wall_s=wall, dones_by_version={str(k): v for k, v in
                                               by_version.items()},
                canaries_sent=st["canaries_sent"],
                canaries_ok=st["canaries_ok"],
                replicas_swapped=box["out"]["replicas_swapped"],
                golden_matches_generate=gold1 == gen1)


def _fleet_frontdoor(ServingFleet, params, cfg, tmp, verify_journal,
                     format_diag, dev="cuda"):
    """(c): a FrontDoor over a two-replica bf16 fleet with two tenants,
    as bench.py's serving_frontdoor sets it up: a capacity estimate from
    one saturating wave, open-loop runs at fractions of it with every
    request streamed, and a streamed request whose client disconnects."""
    from paddle_tpu_torch.serving import FrontDoor, TenantRegistry, WireClient
    from paddle_tpu_torch.serving.loadgen import run_open_loop

    c = FLEET["frontdoor"]
    wa, wb = c["weights"]
    treg = TenantRegistry()
    # generous quotas: the runs measure the fleet, not a token bucket
    treg.add("alice", rate=1e6, burst=1e6, weight=wa)
    treg.add("bob", rate=1e6, burst=1e6, weight=wb)
    auth = {"tok-alice": "alice", "tok-bob": "bob"}
    tenants = [{"name": "alice", "token": "tok-alice", "weight": wa},
               {"name": "bob", "token": "tok-bob", "weight": wb}]
    journal = os.path.join(tmp, "frontdoor.jsonl")
    fleet = _fleet(ServingFleet, params, cfg, c["replicas"], journal, dev,
                   tenants=treg)
    fd = FrontDoor(fleet, auth=auth).start()
    rng = np.random.RandomState(42)
    vocab, plen, mnew = cfg.vocab, c["prompt_len"], c["max_new"]
    try:
        prompt = rng.randint(1, vocab, plen).astype(np.int32)
        dh = fleet.submit(prompt, mnew, seed=3, tenant="alice")
        dh.result(timeout=FLEET["budget_s"])
        wc = WireClient(fd.address, token="tok-alice")
        got = wc.generate_blocking("warm", prompt, mnew, seed=3,
                                   stream=True)
        wc.close()
        check(got["tokens"] == [int(t) for t in dh.tokens]
              and [t for ch in got["chunks"] for t in ch] == got["tokens"],
              "phase 42 (c): the wire answer or its stream differs from "
              "the direct answer")
        hs = [fleet.submit(rng.randint(1, vocab, plen).astype(np.int32),
                           mnew, seed=100 + i, tenant="alice")
              for i in range(c["n_warm"])]
        t0 = time.monotonic()
        for h in hs:
            h.result(timeout=FLEET["budget_s"])
        cap = c["n_warm"] / (time.monotonic() - t0)
        runs = []
        for k, f in enumerate(c["rate_factors"]):
            rate = max(1.0, round(f * cap, 2))
            rep = run_open_loop(
                fd.address, tenants, rate, c["duration_s"], seed=7 + k,
                prompt_len=plen, max_new_tokens=mnew, vocab=vocab,
                stream=True, settle_s=c["settle_s"])
            check(rep["stream_divergent"] == 0
                  and rep["duplicate_rids"] == 0
                  and rep["wire_unresolved"] == 0,
                  "phase 42 (c) %.2f rps: %d streams diverged, %d rids "
                  "duplicated, %d requests without a typed verdict"
                  % (rate, rep["stream_divergent"], rep["duplicate_rids"],
                     rep["wire_unresolved"]))
            runs.append({key: rep[key] for key in (
                "rate_rps", "offered_rps", "goodput_rps", "ttft_p50_s",
                "ttft_p99_s", "itl_p50_s", "itl_p99_s", "completed",
                "sent", "shed")})
            log("  (c) %.2fx capacity (%.2f rps): goodput %.3f rps, TTFT "
                "p50 %.4f s p99 %.4f s, %d of %d completed, shed %s"
                % (f, rate, rep["goodput_rps"], rep["ttft_p50_s"] or -1,
                   rep["ttft_p99_s"] or -1, rep["completed"], rep["sent"],
                   rep["shed"]))
        before = fleet.stats()["cancelled"]
        dc = WireClient(fd.address, token="tok-bob")
        dc.generate("drop", rng.randint(1, vocab, plen), 8 * mnew, seed=50,
                    stream=True)
        frame = dc.recv()
        while frame is not None and frame.get("op") not in ("tokens",
                                                            "done"):
            frame = dc.recv()
        dc.close()
        t1 = time.monotonic()
        while (fleet.stats()["cancelled"] <= before
               or not fd.stats()["disconnect_cancels"]) \
                and time.monotonic() - t1 < 30:
            time.sleep(0.01)
        fd_stats = fd.stats()
        check(fleet.stats()["cancelled"] > before
              and fd_stats["disconnect_cancels"] >= 1,
              "phase 42 (c): the dropped stream was not cancelled (last "
              "frame %r, fleet cancelled %d, front door %s)"
              % (frame, fleet.stats()["cancelled"], fd_stats))
    finally:
        fd.close()
    st = _check_fleet_run("(c) front door", fleet, [dh] + hs, journal,
                          vocab, verify_journal, format_diag)
    kinds = [r["kind"] for r in _journal_records(journal)]
    check("cancelled" in kinds, "phase 42 (c): no cancelled record")
    log("  (c) capacity %.2f rps from %d requests; the disconnect "
        "journaled `cancelled`; cancelled %d, shed %d"
        % (cap, c["n_warm"], st["cancelled"], st["shed"]))
    return dict(capacity_rps=cap, runs=runs, cancelled=st["cancelled"],
                disconnect_cancels=fd_stats["disconnect_cancels"])


def _fleet_batch_lane(torch, T, ServingFleet, params, cfg, tmp,
                      verify_journal, format_diag, dev="cuda"):
    """(d): Fluid LeNet inference at batch 64 through submit_batch
    (executor_batch_fn) between f32 LM requests; every job's fetch
    equals a direct Executor.run of the same program and feed."""
    from paddle_tpu_torch import fluid
    from paddle_tpu_torch.models import lenet
    from paddle_tpu_torch.serving import TenantRegistry, executor_batch_fn

    c = FLEET["batch"]
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        image = fluid.layers.data(name="image", shape=[1, 28, 28],
                                  dtype="float32")
        predict = lenet.lenet(image, 10)
    place = fluid.CUDAPlace(0) if dev == "cuda" else fluid.CPUPlace()
    scope = fluid.Scope()
    exe = fluid.Executor(place)
    with fluid.scope_guard(scope):
        exe.run(startup)
    feeds = [{"image": book_image_feed(torch, BOOK_IMAGE["lenet_mnist"],
                                       c["batch"], dev, seed=s)["image"]}
             for s in range(c["jobs"])]
    with fluid.scope_guard(scope):
        direct = [exe.run(main, feed=f, fetch_list=[predict])[0]
                  for f in feeds]
    p32 = _tree_map(lambda t: t.float(), params)
    cfg32 = T.TransformerConfig(vocab=cfg.vocab, dim=cfg.dim,
                                heads=cfg.heads, layers=cfg.layers,
                                max_len=cfg.max_len)
    treg = TenantRegistry()
    treg.add("lm", rate=1e6, burst=1e6, weight=1.0)
    treg.add("zoo", rate=1e6, burst=1e6, weight=1.0)
    journal = os.path.join(tmp, "batch_lane.jsonl")
    fleet = _fleet(ServingFleet, p32, cfg32, 1, journal, dev, tenants=treg)
    reqs, _ = poisson_trace(cfg.vocab, seed=3)
    lm, jobs = [], []
    for k in range(max(c["lm_requests"], c["jobs"])):
        if k < c["lm_requests"]:
            prompt, m = reqs[k]
            lm.append(fleet.submit(prompt, m, tenant="lm",
                                   publish_len=POISSON["header"]))
        if k < c["jobs"]:
            jobs.append(fleet.submit_batch(
                executor_batch_fn(exe, main, feeds[k], [predict],
                                  scope=scope),
                tenant="zoo", cost=float(c["batch"])))
    for h in lm + jobs:
        h.result(timeout=FLEET["budget_s"])
    err = max(float(np.abs(np.asarray(j.batch_result[0]) - d).max())
              for j, d in zip(jobs, direct))
    check(err <= 1e-5, "phase 42 (d): batch-lane fetches differ from the "
          "direct run by %.3g (bar 1e-5)" % err)
    st = _check_fleet_run("(d) batch lane", fleet, lm + jobs, journal,
                          cfg.vocab, verify_journal, format_diag)
    check(st["batch_jobs_completed"] == c["jobs"],
          "phase 42 (d): %d batch jobs completed of %d"
          % (st["batch_jobs_completed"], c["jobs"]))
    log("  (d) %d LeNet batches of %d through the batch lane between %d "
        "f32 LM requests: max |fleet - direct| %.3g"
        % (c["jobs"], c["batch"], len(lm), err))
    return dict(jobs=c["jobs"], batch=c["batch"], lm_requests=len(lm),
                max_abs_err=err)


def phase_fleet(torch, T, tpa, card="cpu", dev="cuda", full=FULL):
    """Phase 42 (see the module docstring); `dev="cpu"` and a small
    `full` rehearse it on the CPU."""
    import importlib
    import shutil
    import tempfile

    from paddle_tpu_torch.analysis.diagnostics import format_diag
    from paddle_tpu_torch.analysis.protocol_lint import verify_journal
    from paddle_tpu_torch.serving import (ServingEngine, ServingFleet,
                                          save_weights)

    # the module (the package re-exports its function under this name)
    tfa = importlib.import_module("paddle_tpu_torch.parallel.flash_attention")
    tmp = tempfile.mkdtemp(prefix="phase42_")
    cfg = T.TransformerConfig(dtype=torch.bfloat16, **full)
    params = T.init_params(
        cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    reqs, arrive = poisson_trace(cfg.vocab, seed=0)
    out = {"card": card}
    serve = functools.partial(_fleet_serve, torch, tpa, ServingFleet,
                              params, cfg, reqs=reqs, arrive=arrive,
                              tmp=tmp, verify_journal=verify_journal,
                              format_diag=format_diag, dev=dev)
    # flash is not on the serving path: its counters must not move
    # between the first fleet run and the last
    flash_before = dict(tfa.launches)
    try:
        t0 = time.monotonic()
        out["n1"], _ = serve(n=1, label="N=1")
        out["n3"], _ = serve(n=FLEET["replicas"], label="N=3")
        out["n3_kill"], _ = serve(n=FLEET["replicas"], label="N=3 kill",
                                  kill=True, exact=False)
        check(out["n3_kill"]["failovers"] == 1,
              "phase 42 (a): the kill run made %d failovers, not 1"
              % out["n3_kill"]["failovers"])
        store = os.path.join(tmp, "kv_store")
        out["tiered"], _ = serve(
            n=3, label="tiered", replica_tier=["prefill", "decode",
                                               "decode"],
            kv_store_dir=store,
            engine=dict(ENGINE, kv_fingerprints=True))
        qreqs = [(p, min(m, FLEET["quant_max_new"]))
                 for p, m in reqs[:FLEET["quant_requests"]]]
        for kvq in ("int8", "fp8"):
            out["n3_" + kvq], _ = serve(
                n=FLEET["replicas"], label="N=3 %s pool" % kvq,
                engine=dict(ENGINE, kv_quant=kvq), reqs=qreqs,
                arrive=arrive[:FLEET["quant_requests"]])
        check(out["tiered"]["handoff_imports"] > 0
              and out["tiered"]["migrations"] > 0
              and out["tiered"]["tokens_recomputed_at_migration"] == 0,
              "phase 42 (a) tiered: migrations %d, handoff imports %d, "
              "tokens recomputed at migration %d (bench.py:3328-3335's bar: "
              "0 with an import)" % (out["tiered"]["migrations"],
                                     out["tiered"]["handoff_imports"],
                                     out["tiered"][
                                         "tokens_recomputed_at_migration"]))
        t1 = time.monotonic()
        out["f32_kill"] = _fleet_f32_drill(
            torch, T, ServingEngine, ServingFleet, params, cfg, tmp,
            verify_journal, format_diag, dev=dev)
        t2 = time.monotonic()
        out["rollout"] = _fleet_rollout(
            torch, T, ServingEngine, ServingFleet, save_weights, params,
            cfg, tmp, verify_journal, format_diag, dev=dev)
        t3 = time.monotonic()
        out["frontdoor"] = _fleet_frontdoor(
            ServingFleet, params, cfg, tmp, verify_journal, format_diag,
            dev=dev)
        t4 = time.monotonic()
        out["batch_lane"] = _fleet_batch_lane(
            torch, T, ServingFleet, params, cfg, tmp, verify_journal,
            format_diag, dev=dev)
        out["seconds"] = dict(a=t1 - t0, a_f32=t2 - t1, b=t3 - t2,
                              c=t4 - t3, d=time.monotonic() - t4)
        out["flash_launches"] = {k: tfa.launches[k] - flash_before[k]
                                 for k in tfa.launches}
        check(not any(out["flash_launches"].values()),
              "phase 42: the fleet launched flash kernels: %s"
              % out["flash_launches"])
        out["launches"] = {k: out[k]["launches"]
                           for k in ("n1", "n3", "n3_kill", "tiered",
                                     "n3_int8", "n3_fp8")}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    log("  (a) tokens/s: N=1 %.1f, N=3 %.1f (N=3 / N=1 %.3f)"
        % (out["n1"]["tokens_per_s"], out["n3"]["tokens_per_s"],
           out["n3"]["tokens_per_s"] / out["n1"]["tokens_per_s"]))
    return out


# ---------------------------------------------------------------------
# phase 43: the LM's remaining paths (sequence, expert, tensor and
# pipeline parallelism on two gloo ranks; the Switch LM on one rank)
# ---------------------------------------------------------------------

LM_PATHS = dict(
    # (a) phase 3's model over {seq: 2}: 2,048 rows a rank
    seq=dict(batch=2, seq=4096, steps=3, lr=1e-3),
    # (b) the Switch LM over {expert: 2}: 8 x 1,024 tokens
    moe=dict(experts=8, every=2, batch=8, seq=1024, cf_f32=8.0,
             cf_bf16=1.25, steps=3, lr=1e-3),
    # (c) phase 3's model in f32 over {model: 2}
    tp=dict(batch=4, seq=1024),
    # (d) two GELU MLP stages 512 -> 2048 -> 512 over {pipe: 2}
    pipe=dict(micro=8, batch=256, width=512, hidden=2048),
    # (e) the Switch LM on one rank
    lm=dict(steps=10, lr=0.5, gen_batch=2, prompt=64, new=32, slots=16,
            chunk=128, decode_steps=8, beam_batch=2, beam=4,
            prefill_prompt=512, prefill_chunk=128))


def _pattern_tokens(vocab, batch, seq, seed):
    """[batch, seq + 1] rows counting up from a seeded start (next token
    = token + 1 mod vocab): a pattern a few SGD steps learn."""
    rng = np.random.RandomState(seed)
    start = rng.randint(0, vocab, (batch, 1))
    return (start + np.arange(seq + 1)) % vocab


def _timed(torch, dev, fn):
    """(result, host ms, device ms) of fn() ending in a sync; device ms
    from CUDA events (None on the CPU)."""
    if dev.type == "cuda":
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        e0.record()
    t0 = time.monotonic()
    out = fn()
    if dev.type == "cuda":
        e1.record()
        torch.cuda.synchronize()
    host = (time.monotonic() - t0) * 1e3
    return out, host, (e0.elapsed_time(e1) if dev.type == "cuda" else None)


def _lm_seq(torch, T, tfa, make_mesh, all_reduce, dev, full,
            cfg=LM_PATHS["seq"]):
    """(a): forward with ring, zigzag and flash (Ulysses) over {seq: 2}
    against this rank's one-device forward through the flash kernels,
    then SGD steps through Ulysses + flash with the flash counters
    zeroed just before and read just after."""
    tcfg = T.TransformerConfig(dtype=torch.bfloat16,
                               **dict(full, max_len=cfg["seq"]))
    params = T.init_params(tcfg, torch.Generator(device=dev).manual_seed(0),
                           device=dev)
    toks = torch.from_numpy(_pattern_tokens(
        tcfg.vocab, cfg["batch"], cfg["seq"], 0)).to(dev)
    inp = toks[:, :-1]
    mesh = make_mesh({"seq": 2}, device=dev)
    out = {}
    # the group's first collective sets up gloo's transport: timed apart
    _, host, _ = _timed(torch, dev, lambda: all_reduce(
        torch.ones(1, device=dev), mesh.group("seq")))
    out["first_collective_ms"] = host
    with torch.no_grad():
        T.forward(params, inp, tcfg, attn_impl="flash")  # warm
        ref, host, devms = _timed(torch, dev, lambda: T.forward(
            params, inp, tcfg, attn_impl="flash"))
        scale = float(ref.float().abs().max())
        out["one_rank_flash"] = dict(host_ms=host, device_ms=devms,
                                     max_abs_logit=scale)
        for impl in ("ring", "zigzag", "flash"):
            got, host, devms = _timed(torch, dev, lambda: T.forward(
                params, inp, tcfg, mesh=mesh, attn_impl=impl))
            err = float((got.float() - ref.float()).abs().max())
            # held at the bf16 bar of the flash checks, 2e-2 scaled by
            # the largest |value|; the absolute 2e-2 is logged beside it
            # (under one bf16 step, 2 ** -5, for |logit| in [4, 8))
            out[impl] = dict(max_abs_err=err,
                             within_2e_2=err <= 2e-2 * max(1.0, scale),
                             within_2e_2_abs=err <= 2e-2,
                             host_ms=host, device_ms=devms)
            del got
    del ref
    step = T.make_train_step(tcfg, lr=cfg["lr"], mesh=mesh,
                             attn_impl="flash")
    mesh.sync_stats.reset()
    for key in tfa.launches:
        tfa.launches[key] = 0
    losses, times = [], []
    for _ in range(cfg["steps"]):
        (_, loss), host, devms = _timed(torch, dev, lambda: step(params,
                                                                 toks))
        losses.append(float(loss))
        times.append((host, devms))
    out.update(losses=losses, step_host_ms=[t[0] for t in times],
               step_device_ms=[t[1] for t in times],
               launches=dict(tfa.launches),
               exchanges=mesh.sync_stats.exchanges,
               exchange_bytes=mesh.sync_stats.exchange_bytes,
               grad_sync_bytes=mesh.sync_stats.bytes)
    return out


def _lm_moe(torch, T, make_mesh, dev, full, cfg=LM_PATHS["moe"]):
    """(b): the Switch LM over {expert: 2}: in f32 with capacity factor
    cf_f32 (nothing dropped) the loss against this rank's one-device
    loss through reference_moe; then SGD steps in bf16 at cf_bf16. The
    tokens of this rank's block that found no slot are read from the
    mesh's SyncStats, reset just before each part."""
    mesh = make_mesh({"expert": 2}, device=dev)
    moe = dict(full, moe_experts=cfg["experts"], moe_every=cfg["every"])
    toks = torch.from_numpy(_pattern_tokens(
        full["vocab"], cfg["batch"], cfg["seq"], 1)).to(dev)
    out = {}
    c32 = T.TransformerConfig(moe_capacity_factor=cfg["cf_f32"], **moe)
    p32 = T.init_params(c32, torch.Generator(device=dev).manual_seed(2),
                        device=dev)
    with torch.no_grad():
        ref, host1, dev1 = _timed(torch, dev, lambda: T.loss_fn(
            p32, toks, c32))
        mesh.sync_stats.reset()
        got, host2, dev2 = _timed(torch, dev, lambda: T.loss_fn(
            p32, toks, c32, mesh=mesh))
    out["f32"] = dict(loss=float(got), one_rank_loss=float(ref),
                      rel_err=abs(float(got) - float(ref)) / abs(float(ref)),
                      dropped=int(mesh.sync_stats.dropped_tokens),
                      one_rank_host_ms=host1, one_rank_device_ms=dev1,
                      host_ms=host2, device_ms=dev2)
    del p32
    c16 = T.TransformerConfig(dtype=torch.bfloat16,
                              moe_capacity_factor=cfg["cf_bf16"], **moe)
    p16 = T.init_params(c16, torch.Generator(device=dev).manual_seed(2),
                        device=dev)
    step = T.make_train_step(c16, lr=cfg["lr"], mesh=mesh)
    mesh.sync_stats.reset()
    losses, times = [], []
    for _ in range(cfg["steps"]):
        (_, loss), host, devms = _timed(torch, dev, lambda: step(p16, toks))
        losses.append(float(loss))
        times.append((host, devms))
    # one MoE forward per MoE block per step, each over this rank's half
    calls = cfg["steps"] * sum(map(c16.is_moe_block, range(c16.layers)))
    out["bf16"] = dict(losses=losses,
                       dropped=int(mesh.sync_stats.dropped_tokens),
                       tokens_routed=cfg["batch"] * cfg["seq"] * calls // 2,
                       moe_calls=calls,
                       step_host_ms=[t[0] for t in times],
                       step_device_ms=[t[1] for t in times],
                       exchanges=mesh.sync_stats.exchanges)
    return out


def _lm_tp(torch, T, make_mesh, dev, full, cfg=LM_PATHS["tp"]):
    """(c): phase 3's model in f32 with its parameters laid out by
    param_specs over {model: 2} (each rank holds its blocks): the loss
    against this rank's one-device loss."""
    mesh = make_mesh({"model": 2}, device=dev)
    tcfg = T.TransformerConfig(**full)
    params = T.init_params(tcfg, torch.Generator(device=dev).manual_seed(3),
                           device=dev)
    toks = torch.from_numpy(_pattern_tokens(
        tcfg.vocab, cfg["batch"], cfg["seq"], 2)).to(dev)
    blocks = T.shard_params(params, tcfg, mesh)
    held = sum(t.numel() for t in T._leaves(blocks))
    whole = sum(t.numel() for t in T._leaves(params))
    with torch.no_grad():
        ref, host1, dev1 = _timed(torch, dev, lambda: T.loss_fn(
            params, toks, tcfg))
        got, host2, dev2 = _timed(torch, dev, lambda: T.loss_fn(
            blocks, toks, tcfg, mesh=mesh))
    return dict(loss=float(got), one_rank_loss=float(ref),
                rel_err=abs(float(got) - float(ref)) / abs(float(ref)),
                params_held=held, params_whole=whole,
                one_rank_host_ms=host1, one_rank_device_ms=dev1,
                host_ms=host2, device_ms=dev2)


def _gelu_stage(p, h):
    import torch.nn.functional as F

    return F.gelu(h @ p["w1"] + p["b1"]) @ p["w2"] + p["b2"]


def _lm_pipe(torch, make_mesh, gpipe_pipeline, reference_pipeline,
             all_reduce, dev, rank, cfg=LM_PATHS["pipe"]):
    """(d): two GELU MLP stages over {pipe: 2}, each rank holding its own
    stage, f32: forward and the gradients of sum(y ** 2) (seeded 1 /
    ranks, summed over the axis) against reference_pipeline's on this
    rank; max |difference| over max |reference| per tensor."""
    mesh = make_mesh({"pipe": 2}, device=dev)
    g = torch.Generator(device=dev).manual_seed(4)
    W, Hd, B = cfg["width"], cfg["hidden"], cfg["batch"]
    full = {"w1": torch.randn(2, W, Hd, generator=g, device=dev) / W ** 0.5,
            "b1": torch.randn(2, Hd, generator=g, device=dev) * 0.1,
            "w2": torch.randn(2, Hd, W, generator=g, device=dev) / Hd ** 0.5,
            "b2": torch.randn(2, W, generator=g, device=dev) * 0.1}
    x0 = torch.randn(B, W, generator=g, device=dev)

    def grads(fn, params, ranks):
        x = x0.clone().requires_grad_(True)
        y = fn(params, x)
        names = sorted(params)
        gs = torch.autograd.grad(
            (y.float() ** 2).sum(), [params[k] for k in names] + [x],
            grad_outputs=torch.tensor(1.0 / ranks, device=dev))
        return y.detach(), dict(zip(names + ["x"], gs))

    def pipe_fn(p, x):
        return gpipe_pipeline(_gelu_stage, p, x, mesh,
                              n_microbatches=cfg["micro"], stage_local=True)

    ref, rg = grads(lambda p, x: reference_pipeline(_gelu_stage, p, x),
                    {k: v.clone().requires_grad_(True)
                     for k, v in full.items()}, 1)
    mine = {k: v[rank:rank + 1].clone().requires_grad_(True)
            for k, v in full.items()}
    (got, gg), host, devms = _timed(torch, dev,
                                    lambda: grads(pipe_fn, mine, 2))
    gx = all_reduce(gg["x"], mesh.group("pipe"))

    def rel(a, b):
        return float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)

    errs = {"y": rel(got, ref), "x": rel(gx, rg["x"])}
    for k in sorted(full):
        errs[k] = rel(gg[k][0], rg[k][rank])
    return dict(rel_err=errs, host_ms=host, device_ms=devms,
                exchanges=mesh.sync_stats.exchanges)


def lm_worker(rank, tmp, dev="cuda:0", full=None):
    """One of phase 43's two ranks (`chip_smoke.py --lm-worker RANK
    DIR`): a gloo group over a file store in DIR, both ranks on cuda:0
    (NCCL refuses two ranks on one card: a test configuration, not a
    fallback). Runs (a)-(d) and writes its numbers to
    DIR/rank<RANK>.json."""
    import importlib

    import torch
    import torch.distributed as dist

    from paddle_tpu_torch.models import transformer as T
    from paddle_tpu_torch.parallel import (gpipe_pipeline, make_mesh,
                                           reference_pipeline)
    from paddle_tpu_torch.parallel.collectives import all_reduce

    tfa = importlib.import_module("paddle_tpu_torch.parallel.flash_attention")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(dev)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    full = full or FULL
    dist.init_process_group("gloo", init_method="file://" + os.path.join(
        tmp, "store"), rank=rank, world_size=2)
    out = {}
    t0 = time.monotonic()
    out["a"] = _lm_seq(torch, T, tfa, make_mesh, all_reduce, dev, full)
    out["b"] = _lm_moe(torch, T, make_mesh, dev, full)
    out["c"] = _lm_tp(torch, T, make_mesh, dev, full)
    out["d"] = _lm_pipe(torch, make_mesh, gpipe_pipeline, reference_pipeline,
                        all_reduce, dev, rank)
    out["seconds"] = time.monotonic() - t0
    with open(os.path.join(tmp, "rank%d.json" % rank), "w") as f:
        json.dump(out, f)
    dist.destroy_process_group()
    return 0


def _run_ranks(argv, tmp, timeout, label):
    """Start two worker processes (argv + [rank, tmp]), wait for both,
    fail the phase if either fails; their JSON results."""
    here = os.path.abspath(__file__)
    procs = [subprocess.Popen(argv + [str(r), tmp], cwd=os.path.dirname(here),
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for r in range(2)]
    try:
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline and any(
                p.poll() is None for p in procs):
            if any(p.poll() not in (None, 0) for p in procs):
                break
            time.sleep(0.2)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        outs = [p.communicate() for p in procs]
    for r, (p, (so, se)) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            log("  rank %d exited %s; its stderr ends:\n%s"
                % (r, p.returncode, se[-3000:]))
        check(p.returncode == 0, "%s: rank %d failed" % (label, r))
    res = []
    for r in range(2):
        with open(os.path.join(tmp, "rank%d.json" % r)) as f:
            res.append(json.load(f))
    return res


def _lm_switch(torch, T, tfa, tpa, dev, full, card, cfg=LM_PATHS["lm"]):
    """(e): the Switch LM on one rank (bf16 unless stated): SGD steps
    through the flash kernels with the loss falling; greedy generate in
    f32 against the CPU port's; the fused paged decode and prefill over
    16 slots with MoE blocks (counters zeroed just before and read just
    after; logits against the gather path's); beam search (beam 1 =
    greedy, scores sorted); prefill_chunk against prefill in f32."""
    moe = dict(full, moe_experts=LM_PATHS["moe"]["experts"],
               moe_every=LM_PATHS["moe"]["every"])
    out = {}
    c16 = T.TransformerConfig(dtype=torch.bfloat16, **moe)
    params = T.init_params(c16, torch.Generator(device=dev).manual_seed(5),
                           device=dev)
    toks = torch.from_numpy(_pattern_tokens(
        c16.vocab, TRAIN["batch"], TRAIN["seq"], 3)).to(dev)
    step = T.make_train_step(c16, lr=cfg["lr"], attn_impl="flash")
    for key in tfa.launches:
        tfa.launches[key] = 0
    losses = []
    (_, host, devms) = _timed(torch, dev, lambda: [
        losses.append(step(params, toks)[1]) for _ in range(cfg["steps"])])
    losses = [float(x) for x in losses]
    flash = dict(tfa.launches)
    check(all(math.isfinite(x) for x in losses) and losses[-1] < losses[0],
          "phase 43 (e): the Switch LM's loss did not fall: %s" % losses)
    if dev.type == "cuda":
        want = c16.layers * cfg["steps"]
        check(all(n == want for n in flash.values()),
              "phase 43 (e): flash launches %s != layers x steps %d"
              % (flash, want))
    out["train"] = dict(losses=losses, flash_launches=flash,
                        ms_per_step_host=host / cfg["steps"],
                        ms_per_step_device=(devms / cfg["steps"]
                                            if devms else None))
    del step

    # greedy generate in f32, card vs the CPU port on the same weights
    c32 = T.TransformerConfig(**moe)
    p32 = _tree_map(lambda t: t.detach().float(), params)
    rng = np.random.RandomState(6)
    prompt = torch.from_numpy(rng.randint(
        0, c32.vocab, (cfg["gen_batch"], cfg["prompt"]))).to(dev)
    with torch.no_grad():
        got, host, devms = _timed(torch, dev, lambda: T.generate(
            p32, prompt, c32, cfg["new"]))
        p_cpu = _tree_map(lambda t: t.cpu(), p32)
        want = T.generate(p_cpu, prompt.cpu(), c32, cfg["new"])
    same = bool(torch.equal(got.cpu(), want))
    check(same, "phase 43 (e): f32 generate on the card != the CPU port's")
    out["generate_f32"] = dict(tokens_equal_cpu=same, host_ms=host,
                               device_ms=devms)
    del p_cpu

    # beam search (bf16): beam 1 is greedy, scores sorted
    bprompt = prompt[:cfg["beam_batch"]]
    with torch.no_grad():
        greedy = T.generate(params, bprompt, c16, cfg["new"])
        b1, _ = T.beam_search_generate(params, bprompt, c16, cfg["new"],
                                       beam_size=1)
        (beams, scores), host, devms = _timed(
            torch, dev, lambda: T.beam_search_generate(
                params, bprompt, c16, cfg["new"], beam_size=cfg["beam"]))
    stats = dict(T.LAST_DECODE_STATS)
    sorted_ok = bool((scores[:, 1:] <= scores[:, :-1]).all())
    check(torch.equal(b1[:, 0], greedy), "phase 43 (e): beam 1 != greedy")
    check(sorted_ok and bool(torch.isfinite(scores).all()),
          "phase 43 (e): beam scores not finite and sorted")
    out["beam"] = dict(beam1_equals_greedy=True, scores_sorted=sorted_ok,
                       stats=stats, shape=list(beams.shape),
                       host_ms=host, device_ms=devms)

    # prefill_chunk in chunks vs prefill, f32, bit for bit
    pp = torch.from_numpy(rng.randint(0, c32.vocab,
                                      (1, cfg["prefill_prompt"]))).to(dev)
    with torch.no_grad():
        lm, mono = T.prefill(p32, pp, c32, max_len=cfg["prefill_prompt"])
        cache = T.init_kv_cache(c32, 2, max_len=cfg["prefill_prompt"],
                                device=dev)
        C = cfg["prefill_chunk"]
        for s0 in range(0, cfg["prefill_prompt"], C):
            lc, cache = T.prefill_chunk(p32, cache, pp[0, s0:s0 + C], s0, 1,
                                        c32)
    # bit for bit on the CPU (tests/test_torch_generation.py); on the
    # card cuBLAS picks its GEMM kernels by row count (a 128-row
    # projection takes a split-K kernel the 512-row one does not), so
    # the two orders of f32 reduction are held at 1e-5 of the largest
    # value instead, and whether they were bit-equal is logged
    pairs = [(lc, lm[0])] + [(a[b][1], m[b][0]) for a, m in
                             zip(cache, mono) for b in ("k", "v")]
    bit = all(bool(torch.equal(x, y)) for x, y in pairs)
    rel = max(float((x - y).abs().max()) / max(float(y.abs().max()), 1e-30)
              for x, y in pairs)
    check(rel <= 1e-5, "phase 43 (e): chunked prefill left prefill by %.3e"
          % rel)
    # the cause on the card: is a C-row f32 GEMM the first rows of the
    # 512-row one (the projections), and a batched one (the einsums)?
    x = torch.randn(cfg["prefill_prompt"], c32.dim, device=dev)
    w = torch.randn(c32.dim, c32.dim, device=dev)
    rows_2d = bool(torch.equal((x @ w)[:C], x[:C] @ w))
    xb = x.reshape(c32.heads, -1, c32.dim // c32.heads)
    wb = w[:c32.dim // c32.heads].expand(c32.heads, -1, -1)
    rows_bmm = bool(torch.equal(torch.bmm(xb, wb)[:, :C],
                                torch.bmm(xb[:, :C], wb)))
    out["prefill_chunk_f32"] = dict(bit_equal=bit, max_rel_err=rel,
                                    chunks=cfg["prefill_prompt"] // C,
                                    gemm_rows_stable=rows_2d,
                                    bmm_rows_stable=rows_bmm)
    del cache, mono, p32

    # the fused paged decode and prefill with MoE blocks, 16 slots
    S, Bt, C = cfg["slots"], 16, cfg["chunk"]
    maxb = (C + cfg["decode_steps"]) // Bt + 1
    NB = S * maxb
    tables = torch.arange(NB, dtype=torch.int32, device=dev).reshape(S, maxb)
    seqs = torch.from_numpy(rng.randint(
        0, c16.vocab, (S, C + cfg["decode_steps"]))).to(dev)
    caches = {k: T.init_paged_kv_cache(c16, NB, Bt, device=dev)
              for k in ("fused", "gather")}
    for counts in [tpa.launches] + list(tpa.quant_launches.values()):
        for key in counts:
            counts[key] = 0
    last = {}
    with torch.no_grad():
        def run(kernel):
            cache = caches[kernel]
            for s in range(S):
                T.paged_prefill_chunk(params, cache, seqs[s, :C], 0,
                                      tables[s], c16, kernel=kernel)
            for i in range(cfg["decode_steps"]):
                pos = torch.full((S,), C + i, dtype=torch.int32, device=dev)
                lg, _ = T.paged_decode_step(params, seqs[:, C + i], pos,
                                            tables, cache, c16,
                                            kernel=kernel)
            return lg

        last["fused"], host, devms = _timed(torch, dev, lambda: run("fused"))
        counted = dict(tpa.launches)
        counted_quant = {k: dict(v) for k, v in tpa.quant_launches.items()}
        last["gather"] = run("gather")
    err = float((last["fused"].float() - last["gather"].float()).abs().max())
    scale = float(last["gather"].float().abs().max())
    check(err <= 2e-2 * max(1.0, scale), "phase 43 (e): fused paged logits "
          "vs gather %.3e (max |logit| %.3f)" % (err, scale))
    if dev.type == "cuda":
        check(counted["prefill"] == c16.layers * S and
              counted["decode"] == c16.layers * cfg["decode_steps"],
              "phase 43 (e): paged launches %s != layers x chunks %d / "
              "layers x steps %d" % (counted, c16.layers * S,
                                     c16.layers * cfg["decode_steps"]))
    out["paged"] = dict(launches=counted, quant_launches=counted_quant,
                        chunks=S,
                        decode_steps=cfg["decode_steps"],
                        max_abs_err_vs_gather=err, host_ms=host,
                        device_ms=devms)
    return out


def phase_lm_paths(torch, T, tfa, tpa, card="cpu", dev="cuda:0",
                   full=FULL, worker_argv=None, timeout=600):
    """Phase 43: (a)-(d) in two ranks of this script (`--lm-worker`) on
    the card in a gloo group, (e) in this process; each part's numbers
    on a line of its own, device ms beside host ms. (`dev`, `full` and
    `worker_argv` let a rehearsal run on the CPU at a small width.)"""
    import tempfile

    dev = torch.device(dev)
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_lm_")
    argv = worker_argv or [sys.executable, os.path.abspath(__file__),
                           "--lm-worker"]
    t0 = time.monotonic()
    ranks = _run_ranks(argv, tmp, timeout, "phase 43")
    ranks_s = time.monotonic() - t0
    a, b, c, d = ([r[k] for r in ranks] for k in "abcd")
    want = full["layers"] * LM_PATHS["seq"]["steps"]
    _on_card(card, "(a) {seq: 2}, B %d x T %d, bf16: max |logits - one "
             "rank's flash| ring %s, zigzag %s, flash (Ulysses) %s "
             "(held: 2e-2 x max(1, max |logit| %.3f): %s; absolute 2e-2, "
             "logged: %s); the first collective "
             "%.1f ms; forward ms host/device: one rank "
             "%s, ring %s, zigzag %s, ulysses %s; 3 steps Ulysses + flash: "
             "losses %s / %s, ms host/device %s; flash launches per rank "
             "%s (layers x steps = %d); exchanges %d (%d B), gradient sync "
             "%d B" % (
                 LM_PATHS["seq"]["batch"], LM_PATHS["seq"]["seq"],
                 *["%.4f" % a[0][k]["max_abs_err"]
                   for k in ("ring", "zigzag", "flash")],
                 a[0]["one_rank_flash"]["max_abs_logit"],
                 [a[0][k]["within_2e_2"] for k in ("ring", "zigzag",
                                                   "flash")],
                 [a[0][k]["within_2e_2_abs"] for k in ("ring", "zigzag",
                                                       "flash")],
                 a[0]["first_collective_ms"],
                 *["%.1f/%s" % (a[0][k]["host_ms"], _fmt(a[0][k]["device_ms"]))
                   for k in ("one_rank_flash", "ring", "zigzag", "flash")],
                 a[0]["losses"], a[1]["losses"],
                 ["%.1f/%s" % (h, _fmt(dm)) for h, dm in
                  zip(a[0]["step_host_ms"], a[0]["step_device_ms"])],
                 [r["launches"] for r in a], want, a[0]["exchanges"],
                 a[0]["exchange_bytes"], a[0]["grad_sync_bytes"]))
    for r in a:
        check(all(r[k]["within_2e_2"] for k in ("ring", "zigzag", "flash")),
              "phase 43 (a): a sequence-parallel forward left the one-rank "
              "flash forward")
        check(all(math.isfinite(x) for x in r["losses"]),
              "phase 43 (a): a loss is not finite")
        if dev.type == "cuda":
            check(all(n == want for n in r["launches"].values()),
                  "phase 43 (a): flash launches %s != layers x steps %d"
                  % (r["launches"], want))
    check(a[0]["losses"] == a[1]["losses"],
          "phase 43 (a): the ranks' losses differ")
    _on_card(card, "(b) {expert: 2}, %d experts every %d blocks, %d x %d "
             "tokens: f32 (capacity factor %.2f) loss %.6f vs one rank's "
             "reference_moe %.6f, rel %.2e (1e-5), dropped %d; ms host/"
             "device mesh %.1f/%s, one rank %.1f/%s; bf16 (factor %.2f) 3 "
             "steps: losses %s / %s, tokens dropped by rank 0 / rank 1 "
             "%d / %d, each of %d routed, ms host/device %s" % (
                 LM_PATHS["moe"]["experts"], LM_PATHS["moe"]["every"],
                 LM_PATHS["moe"]["batch"], LM_PATHS["moe"]["seq"],
                 LM_PATHS["moe"]["cf_f32"], b[0]["f32"]["loss"],
                 b[0]["f32"]["one_rank_loss"], b[0]["f32"]["rel_err"],
                 b[0]["f32"]["dropped"], b[0]["f32"]["host_ms"],
                 _fmt(b[0]["f32"]["device_ms"]),
                 b[0]["f32"]["one_rank_host_ms"],
                 _fmt(b[0]["f32"]["one_rank_device_ms"]),
                 LM_PATHS["moe"]["cf_bf16"], b[0]["bf16"]["losses"],
                 b[1]["bf16"]["losses"],
                 b[0]["bf16"]["dropped"], b[1]["bf16"]["dropped"],
                 b[0]["bf16"]["tokens_routed"],
                 ["%.1f/%s" % (h, _fmt(dm)) for h, dm in zip(
                     b[0]["bf16"]["step_host_ms"],
                     b[0]["bf16"]["step_device_ms"])]))
    for r in b:
        check(r["f32"]["rel_err"] <= 1e-5 and r["f32"]["dropped"] == 0,
              "phase 43 (b): the expert-parallel f32 loss left reference_moe")
        check(all(math.isfinite(x) for x in r["bf16"]["losses"]),
              "phase 43 (b): a bf16 loss is not finite")
    check(b[0]["bf16"]["losses"] == b[1]["bf16"]["losses"],
          "phase 43 (b): the ranks' losses differ")
    _on_card(card, "(c) {model: 2}, f32, B %d x T %d, parameters laid out "
             "by param_specs (%d of %d elements a rank): loss %.6f vs one "
             "rank's %.6f, rel %.2e (1e-5); ms host/device mesh %.1f/%s, "
             "one rank %.1f/%s" % (
                 LM_PATHS["tp"]["batch"], LM_PATHS["tp"]["seq"],
                 c[0]["params_held"], c[0]["params_whole"], c[0]["loss"],
                 c[0]["one_rank_loss"], c[0]["rel_err"], c[0]["host_ms"],
                 _fmt(c[0]["device_ms"]), c[0]["one_rank_host_ms"],
                 _fmt(c[0]["one_rank_device_ms"])))
    for r in c:
        check(r["rel_err"] <= 1e-5 and r["params_held"] < r["params_whole"],
              "phase 43 (c): the tensor-parallel loss left the one-rank loss")
    _on_card(card, "(d) {pipe: 2}, %d microbatches, GELU MLP %d -> %d -> %d "
             "stages at B %d, f32: max rel |gpipe - reference_pipeline| %s "
             "(1e-5); forward + backward ms host/device %.1f/%s" % (
                 LM_PATHS["pipe"]["micro"], LM_PATHS["pipe"]["width"],
                 LM_PATHS["pipe"]["hidden"], LM_PATHS["pipe"]["width"],
                 LM_PATHS["pipe"]["batch"],
                 {k: "%.2e" % max(r["rel_err"][k] for r in d)
                  for k in d[0]["rel_err"]},
                 d[0]["host_ms"], _fmt(d[0]["device_ms"])))
    for r in d:
        check(max(r["rel_err"].values()) <= 1e-5,
              "phase 43 (d): the pipeline left reference_pipeline")
    t1 = time.monotonic()
    e = _lm_switch(torch, T, tfa, tpa, dev, full, card)
    e_s = time.monotonic() - t1
    _on_card(card, "(e) the Switch LM (%d experts every %d blocks), one rank: "
             "%d bf16 SGD steps through flash, losses %.4f -> %.4f, ms/step "
             "host/device %.1f/%s, flash launches %s; f32 greedy generate "
             "equals the CPU port's: %s; beam %d: beam 1 = greedy, scores "
             "sorted, LAST_DECODE_STATS %s; prefill_chunk (%d chunks) vs "
             "prefill in f32: bit-equal %s, max rel %.2e (1e-5; a %d-row f32 "
             "GEMM equals the first rows of the %d-row one: %s, batched: "
             "%s); paged fused over %d slots: "
             "launches %s (layers x chunks %d, layers x steps %d), over "
             "quantized pools %s, logits "
             "vs gather %.4f; (e) took %.1f s, the ranks %.1f s" % (
                 LM_PATHS["moe"]["experts"], LM_PATHS["moe"]["every"],
                 LM_PATHS["lm"]["steps"], e["train"]["losses"][0],
                 e["train"]["losses"][-1], e["train"]["ms_per_step_host"],
                 _fmt(e["train"]["ms_per_step_device"]),
                 e["train"]["flash_launches"],
                 e["generate_f32"]["tokens_equal_cpu"],
                 LM_PATHS["lm"]["beam"], e["beam"]["stats"],
                 e["prefill_chunk_f32"]["chunks"],
                 e["prefill_chunk_f32"]["bit_equal"],
                 e["prefill_chunk_f32"]["max_rel_err"],
                 LM_PATHS["lm"]["prefill_chunk"],
                 LM_PATHS["lm"]["prefill_prompt"],
                 e["prefill_chunk_f32"]["gemm_rows_stable"],
                 e["prefill_chunk_f32"]["bmm_rows_stable"],
                 LM_PATHS["lm"]["slots"], e["paged"]["launches"],
                 full["layers"] * LM_PATHS["lm"]["slots"],
                 full["layers"] * LM_PATHS["lm"]["decode_steps"],
                 e["paged"]["quant_launches"],
                 e["paged"]["max_abs_err_vs_gather"], e_s, ranks_s))
    return dict(seq=a[0], moe=b[0], tp=c[0], pipe=d[0], switch=e,
                ranks_s=ranks_s, switch_s=e_s,
                flash_launches=a[0]["launches"],
                switch_flash_launches=e["train"]["flash_launches"],
                paged_launches=e["paged"]["launches"],
                paged_quant_launches=e["paged"]["quant_launches"])


# ---------------------------------------------------------------------
# phase 44: the v2 book and the deploy path
# ---------------------------------------------------------------------

# phase 44's settings: recognize_digits at LeNet's widths
# (paddle_tpu/models/lenet.py:14; the book's v2 convolutional net, its
# Momentum(0.1 / 128, 0.9)), the book's stacked_lstm_net at its
# published widths (emb 128, hid 512, 3 stacked; Adam(0.002)), fit_a_line
# as tests/test_v2_api.py::test_v2_fit_a_line runs it, and the samples
# the convert round trip must give back (mnist's 512 + 128)
V2_BOOK = dict(digits=dict(batch=64, passes=2, shuffle=8192, infer=128),
               sentiment=dict(emb=128, hid=512, stacked=3, batch=32,
                              lr=0.002, served=32),
               fit_a_line=dict(batch=32, passes=8, shuffle=500, lr=1e-3,
                               momentum=0.9),
               convert=dict(samples=640))


def _v2_lenet(paddle):
    """The book's v2 recognize_digits convolutional net: conv 20@5x5,
    pool 2; conv 50@5x5, pool 2; fc 10 softmax."""
    images = paddle.layer.data(name="pixel",
                               type=paddle.data_type.dense_vector(784))
    label = paddle.layer.data(name="label",
                              type=paddle.data_type.integer_value(10))
    conv_pool_1 = paddle.networks.simple_img_conv_pool(
        input=images, filter_size=5, num_filters=20, num_channel=1,
        pool_size=2, pool_stride=2, act=paddle.activation.Relu())
    conv_pool_2 = paddle.networks.simple_img_conv_pool(
        input=conv_pool_1, filter_size=5, num_filters=50, num_channel=20,
        pool_size=2, pool_stride=2, act=paddle.activation.Relu())
    predict = paddle.layer.fc(input=conv_pool_2, size=10,
                              act=paddle.activation.Softmax())
    cost = paddle.layer.classification_cost(input=predict, label=label)
    return predict, cost


def _pass_costs(paddle, trainer, reader, passes):
    """Train, returning each pass's batch costs."""
    costs = [[] for _ in range(passes)]

    def handler(e):
        if isinstance(e, paddle.event.EndIteration):
            costs[e.pass_id].append(float(e.cost))

    trainer.train(reader=reader, num_passes=passes, event_handler=handler)
    return costs


def _book_digits(torch, paddle, tmp, cfg, runner_built):
    """(a) recognize_digits through the v2 API, then the deploy path."""
    import io
    import random

    from paddle_tpu_torch.native import InferenceRunner
    from paddle_tpu_torch.utils.merge_model import merge_v2_model

    mnist = paddle.dataset.mnist
    t0 = time.monotonic()
    mnist.fetch()  # the IDX files: the readers below decode them
    random.seed(0)  # paddle.reader.shuffle draws from Python's random
    predict, cost = _v2_lenet(paddle)
    params = paddle.parameters.create(cost)
    trainer = paddle.trainer.SGD(
        cost=cost, parameters=params,
        update_equation=paddle.optimizer.Momentum(
            learning_rate=0.1 / 128.0, momentum=0.9,
            regularization=paddle.optimizer.L2Regularization(
                rate=0.0005 * 128)))
    costs = _pass_costs(paddle, trainer, paddle.batch(
        paddle.reader.shuffle(mnist.train(), cfg["shuffle"]), cfg["batch"]),
        cfg["passes"])
    t1 = time.monotonic()
    flat = [c for p in costs for c in p]
    means = [float(np.mean(p)) for p in costs]
    check(len(flat) == cfg["passes"] * (mnist.N_TRAIN // cfg["batch"])
          and all(math.isfinite(c) for c in flat),
          "recognize_digits: %d batch costs, not all finite: %s"
          % (len(flat), flat))
    check(means[-1] < means[0], "recognize_digits: the last pass's mean "
          "cost %.4f is not below the first's %.4f" % (means[-1], means[0]))
    result = trainer.test(reader=paddle.batch(mnist.test(), cfg["batch"]))
    check(math.isfinite(result.cost), "recognize_digits: test cost %r"
          % result.cost)
    test = list(mnist.test()())[:cfg["infer"]]
    imgs = np.stack([img for img, _ in test]).astype(np.float32)
    card = np.asarray(paddle.infer(output_layer=predict, parameters=params,
                                   input=[(img,) for img in imgs]),
                      np.float32)
    t2 = time.monotonic()
    tar = io.BytesIO()
    params.to_tar(tar)
    tar.seek(0)
    bundle = os.path.join(tmp, "digits_bundle")
    merge_v2_model(predict, tar, bundle)
    t3 = time.monotonic()
    runner_built()
    t4 = time.monotonic()
    (host,) = InferenceRunner(bundle).run({"pixel": imgs})
    t5 = time.monotonic()
    err = float(np.abs(host - card).max())
    same = int((host.argmax(1) == card.argmax(1)).sum())
    log("  (a) recognize_digits: pass mean costs %s (batch %d, %d batches "
        "a pass), test cost %.4f; %d test images: runner vs card max abs "
        "err %.3e, argmax equal on %d; train %.2f s, infer %.2f s, merge "
        "%.2f s, waiting for the runner's build %.2f s, runner %.3f s"
        % (["%.4f" % m for m in means], cfg["batch"], len(costs[0]),
           result.cost, len(imgs), err, same, t1 - t0, t2 - t1, t3 - t2,
           t4 - t3, t5 - t4))
    check(card.shape == host.shape == (cfg["infer"], 10),
          "recognize_digits: probabilities %s vs %s" % (card.shape,
                                                       host.shape))
    check(err <= 1e-4, "recognize_digits: the runner's probabilities are "
          "%.3e from the card's (bar 1e-4)" % err)
    check(same == len(imgs), "recognize_digits: argmax differs on %d of "
          "%d images" % (len(imgs) - same, len(imgs)))
    return dict(pass_mean_costs=means, test_cost=float(result.cost),
                test_metrics={k: float(v) for k, v in
                              (result.evaluator or {}).items()},
                runner_max_abs_err=err, argmax_equal=same,
                images=len(imgs), seconds=dict(
                    train=t1 - t0, infer=t2 - t1, merge=t3 - t2,
                    build_wait=t4 - t3, runner=t5 - t4))


def _stacked_lstm_net(fluid, data, label, input_dim, emb_dim, hid_dim,
                      stacked_num, class_dim=2):
    """The book's stacked_lstm_net (tests/test_understand_sentiment.py:52
    runs it narrower): fc + dynamic_lstm, stacked, alternating
    is_reverse, max pooling of the last fc and lstm, softmax."""
    emb = fluid.layers.embedding(input=data, size=[input_dim, emb_dim])
    fc1 = fluid.layers.fc(input=emb, size=hid_dim)
    lstm1, _ = fluid.layers.dynamic_lstm(input=fc1, size=hid_dim)
    inputs = [fc1, lstm1]
    for i in range(2, stacked_num + 1):
        fc = fluid.layers.fc(input=inputs, size=hid_dim)
        lstm, _ = fluid.layers.dynamic_lstm(input=fc, size=hid_dim,
                                            is_reverse=(i % 2) == 0)
        inputs = [fc, lstm]
    fc_last = fluid.layers.sequence_pool(input=inputs[0], pool_type="max")
    lstm_last = fluid.layers.sequence_pool(input=inputs[1], pool_type="max")
    prediction = fluid.layers.fc(input=[fc_last, lstm_last],
                                 size=class_dim, act="softmax")
    cost = fluid.layers.cross_entropy(input=prediction, label=label)
    return fluid.layers.mean(x=cost), prediction


def _book_sentiment(torch, paddle, tmp, cfg, place, runner_built):
    """(b) understand_sentiment through Fluid, then the runner."""
    from paddle_tpu_torch.native import InferenceRunner

    fluid = paddle.fluid
    imdb = paddle.dataset.imdb
    t0 = time.monotonic()
    imdb.fetch()
    word_dict = imdb.word_dict()
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        data = fluid.layers.data(name="words", shape=[1], dtype="int64",
                                 lod_level=1)
        label = fluid.layers.data(name="label", shape=[1], dtype="int64")
        avg_cost, prediction = _stacked_lstm_net(
            fluid, data, label, len(word_dict), cfg["emb"], cfg["hid"],
            cfg["stacked"])
        infer = main.clone(for_test=True)
        fluid.optimizer.Adam(learning_rate=cfg["lr"]).minimize(avg_cost)
    exe = fluid.Executor(place)
    feeder = fluid.DataFeeder(feed_list=[data, label], place=place)
    scope = fluid.Scope()
    costs = []
    with fluid.scope_guard(scope):
        exe.run(startup)
        for batch in paddle.batch(imdb.train(word_dict), cfg["batch"])():
            (c,) = exe.run(main, feed=feeder.feed(batch),
                           fetch_list=[avg_cost])
            costs.append(float(np.ravel(np.asarray(c))[0]))
        t1 = time.monotonic()
        check(costs and all(math.isfinite(c) for c in costs),
              "understand_sentiment: costs %s" % costs)
        served = list(imdb.test(word_dict)())[:cfg["served"]]
        feed = feeder.feed([(w, 0) for w, _ in served])
        (card,) = exe.run(infer, feed={"words": feed["words"]},
                          fetch_list=[infer.global_block().var(
                              prediction.name)])
        card = np.asarray(card, np.float32)
        bundle = os.path.join(tmp, "sentiment_bundle")
        fluid.io.save_inference_model(bundle, ["words"], [prediction], exe,
                                      main_program=main)
    t2 = time.monotonic()
    runner_built()
    flat, (offsets,) = feed["words"]
    (host,) = InferenceRunner(bundle).run(
        {"words": flat}, lods={"words": np.asarray(offsets, np.int64)})
    t3 = time.monotonic()
    err = float(np.abs(host - card).max())
    lens = np.diff(offsets)
    log("  (b) understand_sentiment: stacked_lstm_net emb %d hid %d x %d "
        "over %d words, %d Adam steps at batch %d, costs %.4f -> %.4f; %d "
        "reviews (%d-%d words): runner vs card max abs err %.3e; train "
        "%.2f s, infer + save %.2f s, runner %.3f s"
        % (cfg["emb"], cfg["hid"], cfg["stacked"], len(word_dict),
           len(costs), cfg["batch"], costs[0], costs[-1], len(served),
           int(lens.min()), int(lens.max()), err, t1 - t0, t2 - t1,
           t3 - t2))
    check(card.shape == host.shape == (cfg["served"], 2),
          "understand_sentiment: outputs %s vs %s" % (card.shape,
                                                     host.shape))
    check(err <= 1e-4, "understand_sentiment: the runner's outputs are "
          "%.3e from the card's (bar 1e-4)" % err)
    return dict(costs=costs, dict_size=len(word_dict), reviews=len(served),
                runner_max_abs_err=err, seconds=dict(
                    train=t1 - t0, infer_save=t2 - t1, runner=t3 - t2))


def _book_fit_a_line(paddle, cfg):
    """(c) fit_a_line on uci_housing (tests/test_v2_api.py:86's run)."""
    import random

    random.seed(0)
    x = paddle.layer.data(name="x", type=paddle.data_type.dense_vector(13))
    y_predict = paddle.layer.fc(input=x, size=1)
    y = paddle.layer.data(name="y", type=paddle.data_type.dense_vector(1))
    cost = paddle.layer.mse_cost(input=y_predict, label=y)
    params = paddle.parameters.create(cost)
    trainer = paddle.trainer.SGD(
        cost=cost, parameters=params,
        update_equation=paddle.optimizer.Momentum(
            momentum=cfg["momentum"], learning_rate=cfg["lr"]))
    t0 = time.monotonic()
    costs = [c for p in _pass_costs(paddle, trainer, paddle.batch(
        paddle.reader.shuffle(paddle.dataset.uci_housing.train(),
                              cfg["shuffle"]), cfg["batch"]),
        cfg["passes"]) for c in p]
    result = trainer.test(reader=paddle.batch(
        paddle.dataset.uci_housing.test(), cfg["batch"]))
    first, last = float(np.mean(costs[:5])), float(np.mean(costs[-5:]))
    log("  (c) fit_a_line: %d Momentum steps, first five costs' mean %.3f, "
        "last five's %.3f (ratio %.3f, bar 0.7), test cost %.3f; %.2f s"
        % (len(costs), first, last, last / first, result.cost,
           time.monotonic() - t0))
    check(costs and all(math.isfinite(c) for c in costs),
          "fit_a_line: costs %s" % costs)
    check(last < 0.7 * first, "fit_a_line: last five costs' mean %.4f is "
          "not under 0.7 x the first five's %.4f" % (last, first))
    check(math.isfinite(result.cost), "fit_a_line: test cost %r"
          % result.cost)
    return dict(first5_mean=first, last5_mean=last, ratio=last / first,
                steps=len(costs), test_cost=float(result.cost),
                seconds=time.monotonic() - t0)


def _book_convert(paddle, tmp, cfg):
    """(d) mnist.convert through the native RecordWriter, read back by
    common.read_converted and v2.reader.creator: the same samples in
    order."""
    from paddle_tpu_torch.v2.reader import creator

    mnist, common = paddle.dataset.mnist, paddle.dataset.common
    t0 = time.monotonic()
    out = os.path.join(tmp, "mnist_records")
    mnist.convert(out)
    want = list(mnist.train()()) + list(mnist.test()())
    paths = [os.path.join(out, n) for n in sorted(os.listdir(out))]
    paths = ([p for p in paths if "mnist_train" in p]
             + [p for p in paths if "mnist_test" in p])
    read = list(common.read_converted(paths)())
    via_creator = list(creator.pickled_records(paths)())

    def same(a, b):
        return len(a) == len(b) and all(
            x[1] == y[1] and x[0].dtype == y[0].dtype
            and x[0].tobytes() == y[0].tobytes() for x, y in zip(a, b))

    log("  (d) mnist.convert: %d samples in %d record files, read back %d "
        "(read_converted) and %d (reader.creator); %.2f s"
        % (len(want), len(paths), len(read), len(via_creator),
           time.monotonic() - t0))
    check(len(want) == cfg["samples"], "convert: %d samples, not %d"
          % (len(want), cfg["samples"]))
    check(same(read, want), "convert: read_converted gave other samples")
    check(same(via_creator, want), "convert: reader.creator gave other "
          "samples")
    return dict(samples=len(want), files=len(paths),
                seconds=time.monotonic() - t0)


def phase_v2_book(torch, card="cpu", use_gpu=True, cfg=V2_BOOK):
    """Phase 44 (see the module docstring): the book's v2 and Fluid
    scripts on the card from their own readers, deployed to the native
    runner. `use_gpu=False` rehearses it on the CPU."""
    import importlib.util
    import shutil
    import tempfile
    import threading

    import paddle_tpu_torch.v2 as paddle
    from paddle_tpu_torch import native

    t_start = time.monotonic()
    tmp = tempfile.mkdtemp(prefix="phase44_")
    common = paddle.dataset.common
    home = common.DATA_HOME
    common.DATA_HOME = os.path.join(tmp, "data")
    # g++ builds the runner while the card trains
    built = {}

    def build():
        t0 = time.monotonic()
        try:
            built["path"] = native.infer_lib_path()
        except Exception as e:  # raised again where the runner is needed
            built["error"] = e
        built["seconds"] = time.monotonic() - t0

    build_thread = threading.Thread(target=build, daemon=True)
    build_thread.start()

    def runner_built():
        build_thread.join()
        if "error" in built:
            raise built["error"]

    place = paddle.fluid.CUDAPlace(0) if use_gpu else \
        paddle.fluid.CPUPlace()
    out = {"card": card}
    try:
        paddle.init(use_gpu=use_gpu, trainer_count=1)
        out["recognize_digits"] = _book_digits(
            torch, paddle, tmp, cfg["digits"], runner_built)
        out["understand_sentiment"] = _book_sentiment(
            torch, paddle, tmp, cfg["sentiment"], place, runner_built)
        out["fit_a_line"] = _book_fit_a_line(paddle, cfg["fit_a_line"])
        out["convert"] = _book_convert(paddle, tmp, cfg["convert"])
    finally:
        build_thread.join()
        common.DATA_HOME = home
        paddle.init()
        shutil.rmtree(tmp, ignore_errors=True)
    out["runner_build_seconds"] = built["seconds"]
    out["seconds"] = time.monotonic() - t_start
    out["installed"] = {m: importlib.util.find_spec(m) is not None
                        for m in ("PIL", "matplotlib", "scipy")}
    out["left_out"] = ("flowers, voc2012, v2.image and v2.plot: they decode "
                       "images with PIL and draw with matplotlib; their "
                       "parity runs in the CPU tests")
    log("  phase 44: %.1f s (the runner's g++ build %.1f s, beside the "
        "training); installed here: %s; left out: %s"
        % (out["seconds"], built["seconds"], out["installed"],
           out["left_out"]))
    return out


# ---------------------------------------------------------------------
# phase 45: the image, config and conversion tools and the analyzers
# ---------------------------------------------------------------------

# phase 45's settings: small_vgg at its own dataset scale (CIFAR's 32x32
# colour images, 10 classes; paddle_tpu/utils/predefined_net.py:173) with
# training_settings()' batch 128; 64 seeded JPEGs a class, 4 in 5 of
# them to train (4 batches of 128), the rest to test
TOOLS = dict(classes=10, per_class=64, size=32, batch=128, batches=4,
             procs=4, seed=45)

_TOOLS_VGG_CONF = """\
from paddle_tpu_torch.utils import predefined_net
data_conf = predefined_net.image_data(get_config_arg("data_dir", str, "."),
                                      %(size)d)
predefined_net.training_settings(batch_size=%(batch)d)
predefined_net.small_vgg(data_conf)
"""

_TOOLS_BN_CONF = """\
from paddle_tpu_torch.utils import predefined_net
data_conf = predefined_net.image_data(get_config_arg("data_dir", str, "."),
                                      %(size)d)
predefined_net.training_settings(batch_size=%(batch)d)
predefined_net.simple_conv_net(data_conf, is_color=True)
"""

# the provider predefined_net.image_data names (module image_provider,
# obj processData; the reference's image-classification demo): the
# creater's pickled JPEG batches, decoded and mean-subtracted
_TOOLS_PROVIDER = """\
import pickle

from paddle_tpu_torch.trainer.PyDataProvider2 import (dense_vector,
                                                      integer_value,
                                                      provider)
from paddle_tpu_torch.utils import image_util
from paddle_tpu_torch.utils.image_multiproc import PILTransformer


def hook(settings, meta, mean_img_size, img_size, num_classes, use_jpeg,
         color, **kwargs):
    is_color = color == "color"
    mean = image_util.load_meta(meta, mean_img_size, img_size, is_color)
    settings.transformer = PILTransformer(crop_size=img_size,
                                          is_train=False, mean=mean,
                                          is_color=is_color)
    settings.slots = [dense_vector(mean.size), integer_value(num_classes)]


@provider(init_hook=hook)
def processData(settings, file_list):
    for path in file_list:
        with open(path, "rb") as f:
            batch = pickle.load(f)
        for jpeg, label in zip(batch["images"], batch["labels"]):
            img, label = settings.transformer(jpeg, label)
            yield img.ravel(), int(label)
"""


def _tool_images(root, cfg):
    """cfg["classes"] x cfg["per_class"] seeded JPEGs (smooth colour
    fields plus noise, one hue a class) under root/{train,test}/<class>/:
    every fifth image to test."""
    from PIL import Image

    rng = np.random.RandomState(cfg["seed"])
    s = cfg["size"]
    yy, xx = np.mgrid[0:s, 0:s].astype(np.float32) / s
    for c in range(cfg["classes"]):
        hue = np.array([np.cos(c), np.sin(c), np.cos(2 * c)], np.float32)
        for i in range(cfg["per_class"]):
            base = 128 + 60 * hue[None, None, :] * (xx + yy)[..., None]
            img = base + rng.randn(s, s, 3) * 30
            split = "test" if (c * cfg["per_class"] + i) % 5 == 4 else "train"
            d = os.path.join(root, split, "class%02d" % c)
            os.makedirs(d, exist_ok=True)
            Image.fromarray(np.clip(img, 0, 255).astype(np.uint8)).save(
                os.path.join(d, "img%03d.jpg" % i), quality=90)


def _lint_report(proc_out):
    """Findings per code and the baselined count, from the CLI's
    lines."""
    per_code, baselined = {}, 0
    for line in proc_out.splitlines():
        m = re.match(r"\S+:\d+: ([A-Z]\d{3}) ", line)
        if m:
            per_code[m.group(1)] = per_code.get(m.group(1), 0) + 1
            baselined += line.endswith("[baselined]")
    return per_code, baselined


def phase_tools(torch, card="cpu", use_gpu=True, cfg=TOOLS):
    """Phase 45 (see the module docstring): the utils/ tools and the
    analyzers around one small_vgg training on the card. `use_gpu=False`
    rehearses it on the CPU."""
    import contextlib
    import importlib.util
    import io
    import pickle
    import random
    import shutil
    import tempfile

    from paddle_tpu_torch import fluid
    from paddle_tpu_torch.trainer import build_topology, run_config
    from paddle_tpu_torch.utils import (dump_config, dump_v2_config,
                                        image_util, make_model_diagram,
                                        plotcurve, show_pb, torch2paddle)
    from paddle_tpu_torch.utils.image_multiproc import (
        MultiProcessImageTransformer, PILTransformer)
    from paddle_tpu_torch.utils.preprocess_img import \
        ImageClassificationDatasetCreater
    from paddle_tpu_torch.v2.parameters import Parameters

    t_start = time.monotonic()
    here = os.path.dirname(os.path.abspath(__file__))
    # the lint gate runs in its own interpreter beside the rest
    lint = subprocess.Popen(
        [sys.executable, "-m", "paddle_tpu_torch.analysis", "--all"],
        cwd=here, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)
    tmp = tempfile.mkdtemp(prefix="phase45_")
    out, secs = {"card": card}, {}
    try:
        # 1. images to batches and a meta file with the mean image
        t0 = time.monotonic()
        data = os.path.join(tmp, "data")
        _tool_images(data, cfg)
        creater = ImageClassificationDatasetCreater(data, cfg["size"],
                                                    color=True)
        creater.num_per_batch = cfg["batch"]
        random.seed(cfg["seed"])  # permute_by_key's shuffles
        batches = creater.create_batches()
        train_files = [l.strip() for l in open(os.path.join(
            batches, "train.list")) if l.strip()]
        meta_path = os.path.join(batches, "batches.meta")
        with open(meta_path, "rb") as f:
            meta = pickle.load(f)
        check(len(train_files) == cfg["batches"]
              and meta["num_classes"] == cfg["classes"]
              and meta["data_mean"].size == 3 * cfg["size"] ** 2,
              "the creater wrote %d train batches, meta %r"
              % (len(train_files), sorted(meta)))
        secs["images_and_batches"] = time.monotonic() - t0

        # 2. one batch file decoded in a spawn pool inside this process
        t0 = time.monotonic()
        mean = image_util.load_meta(meta_path, cfg["size"], cfg["size"])
        with open(train_files[0], "rb") as f:
            b0 = pickle.load(f)
        with MultiProcessImageTransformer(
                procnum=cfg["procs"], crop_size=cfg["size"],
                is_train=False, mean=mean) as pool:
            pooled = list(pool.run(b0["images"], b0["labels"]))
        local = PILTransformer(crop_size=cfg["size"], is_train=False,
                               mean=mean)
        same = all(
            l == pl and img.dtype == pimg.dtype
            and np.array_equal(img, pimg)
            for (pimg, pl), (img, l) in zip(
                pooled, (local(j, l) for j, l in zip(b0["images"],
                                                     b0["labels"]))))
        check(len(pooled) == cfg["batch"] and same,
              "the pool's %d decoded images differ from the in-process "
              "transformer's" % len(pooled))
        secs["pool_decode"] = time.monotonic() - t0

        # 3. train small_vgg through the legacy trainer on the card
        t0 = time.monotonic()
        conf = os.path.join(tmp, "vgg_conf.py")
        with open(conf, "w") as f:
            f.write(_TOOLS_VGG_CONF % cfg)
        with open(os.path.join(tmp, "image_provider.py"), "w") as f:
            f.write(_TOOLS_PROVIDER)
        args = {"data_dir": data}
        scope = fluid.executor.Scope()
        log_lines = io.StringIO()
        with contextlib.redirect_stdout(log_lines):
            stats = run_config(conf, config_args=args, num_passes=1,
                               log_period=1, use_gpu=use_gpu, scope=scope)
        costs = stats["costs"]
        check(stats["batches"] == cfg["batches"]
              and all(np.isfinite(c) for c in costs),
              "small_vgg trained %d batches, costs %r"
              % (stats["batches"], costs))
        secs["train"] = time.monotonic() - t0

        # 4. the config's program and its diagram
        t0 = time.monotonic()
        vgg_code = dump_config.dump_config(conf, args)
        bn_conf = os.path.join(tmp, "bn_conf.py")
        with open(bn_conf, "w") as f:
            f.write(_TOOLS_BN_CONF % cfg)
        bn_code = dump_config.dump_config(bn_conf, args)
        check(vgg_code.count("conv2d") >= 8 and "conv2d" in bn_code
              and "batch_norm" in bn_code,
              "dump_config printed no conv / batch_norm ops")
        dot = os.path.join(tmp, "bn.dot")
        make_model_diagram.make_diagram(bn_conf, dot, "data_dir=" + data)
        dot_text = open(dot).read()
        check("digraph" in dot_text and "batch_norm" in dot_text,
              "make_model_diagram wrote no graph")

        # 5. the topology to a file and back; the trained weights to a tar
        _state, topo, _cost = build_topology(conf, args)
        pb = os.path.join(tmp, "vgg.json.gz")
        dump_v2_config.dump_v2_config(topo, pb, binary=True)
        shown = io.StringIO()
        show_pb.show_program(show_pb.read_program(pb), shown)
        check("op conv2d" in shown.getvalue(), "show_pb printed no conv2d")
        trained = {n: scope.get(n) for n in scope.keys()
                   if isinstance(scope.get(n), torch.Tensor)
                   and scope.get(n).is_floating_point()}
        on_card = all(t.is_cuda for t in trained.values())
        check(on_card or not use_gpu, "trained parameters not on the card")
        tar = os.path.join(tmp, "vgg.tar")
        written = torch2paddle.torch2paddle(
            trained, {n: n for n in trained}, tar, transpose=())
        with open(tar, "rb") as f:
            back = Parameters.from_tar(f)
        bit_equal = sorted(back.names()) == sorted(trained) and all(
            np.array_equal(np.asarray(back.get(n)),
                           trained[n].detach().cpu().numpy().reshape(
                               np.asarray(back.get(n)).shape))
            for n in trained)
        check(bit_equal and written == sorted(trained),
              "the torch2paddle tar did not read back bit-equal")
        secs["dump_and_convert"] = time.monotonic() - t0

        # 6. the trainer's own log lines through plotcurve
        lines = [l for l in log_lines.getvalue().splitlines()
                 if l.startswith("Pass=")]
        x, _x_test = plotcurve.parse_log(["AvgCost"], lines)
        check(x.shape == (cfg["batches"], 2) and np.allclose(
            x[:, 1], costs, atol=5e-5),
            "parse_log read %r from the trainer's log" % (x.tolist(),))
        drawn = None
        if importlib.util.find_spec("matplotlib") is not None:
            png = os.path.join(tmp, "curve.png")
            plotcurve.plot_paddle_curve(["AvgCost"], iter(lines), png)
            drawn = os.path.getsize(png)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
        # the gate's interpreter ends on its own in seconds: wait for it
        # on every path, so no process outlives the phase
        lint_out = lint.communicate(timeout=300)[0]

    # 7. the lint gate over the port
    per_code, baselined = _lint_report(lint_out)
    check(lint.returncode == 0 and "0 new" in lint_out,
          "python -m paddle_tpu_torch.analysis --all exited %d:\n%s"
          % (lint.returncode, lint_out[-4000:]))
    out.update(
        images=cfg["classes"] * cfg["per_class"], train_batches=len(
            train_files), pool_procs=cfg["procs"],
        pool_bit_equal=same, costs=costs, trained_tensors=len(trained),
        tensors_on_card=on_card, tar_bit_equal=bit_equal,
        plot_bytes=drawn, lint_findings=per_code,
        lint_baselined=baselined, lint_summary=lint_out.strip()
        .splitlines()[-1], sync_free_roots=SYNC_FREE_ROOTS,
        seconds_by_step=secs, seconds=time.monotonic() - t_start)
    _on_card(card, "small_vgg %d batches of %d: costs %s; pool of %d "
             "bit-equal on %d images; %d tensors to the tar and back "
             "bit-equal; parse_log %d lines; plot %s"
             % (stats["batches"], cfg["batch"],
                ", ".join("%.4f" % c for c in costs), cfg["procs"],
                len(pooled), len(trained), len(lines),
                "%d bytes" % drawn if drawn else
                "skipped (no matplotlib)"))
    log("  lint gate: %s; findings by code %s, %d baselined"
        % (out["lint_summary"], per_code, baselined))
    for root, phase in sorted(SYNC_FREE_ROOTS.items()):
        log("  # sync-free root %s: run under set_sync_debug_mode('error') "
            "in %s" % (root, phase))
    log("  phase 45: %.1f s (%s)" % (out["seconds"], ", ".join(
        "%s %.1f s" % kv for kv in secs.items())))
    return out


def _fmt(ms):
    return "n/a" if ms is None else "%.1f" % ms


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if sys.argv[1:2] == ["--mesh-worker"]:
        return mesh_worker(int(sys.argv[2]), sys.argv[3])
    if sys.argv[1:2] == ["--data-worker"]:
        return data_worker(*sys.argv[2:6])
    if sys.argv[1:2] == ["--lm-worker"]:
        return lm_worker(int(sys.argv[2]), sys.argv[3])
    import importlib

    from paddle_tpu_torch import _build
    from paddle_tpu_torch.models import transformer as T
    from paddle_tpu_torch.parallel import paged_attention as tpa
    from paddle_tpu_torch.serving import ServingEngine

    # the module (the package re-exports its function under this name)
    tfa = importlib.import_module("paddle_tpu_torch.parallel.flash_attention")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = gpu_line()
    log(card)
    log("torch %s, CUDA %s, %s x %d" % (
        torch.__version__, torch.version.cuda, torch.cuda.get_device_name(0),
        torch.cuda.device_count()))

    log("phase 1: build")
    t0 = time.monotonic()
    _build.build(["paged_attention", "flash_attention"])  # nvcc in parallel
    log("  built paged_attention and flash_attention in %.1f s"
        % (time.monotonic() - t0))
    paged_report = paged_build_report(_build)
    flash_report = flash_build_report(_build)

    log("phase 2: kernel vs plain version")
    errs, timing = phase_kernels(torch, tpa)

    log("phase 3: serve at full width, bf16")
    cfg = T.TransformerConfig(dtype=torch.bfloat16, **FULL)
    params = T.init_params(
        cfg, torch.Generator(device="cuda").manual_seed(0), device="cuda")
    launches, serve = phase_serve(torch, T, tpa, ServingEngine, params, cfg)

    log("phase 4: f32 engine vs generate()")
    phase_generate(torch, T, ServingEngine, params, cfg)

    if "--profile" in sys.argv[1:]:
        log("profile: bf16 serving trace under torch.profiler")
        phase_profile(torch, ServingEngine, params, cfg)
    del params

    log("phase 5: flash kernels vs plain versions")
    flash_errs, flash_timing = phase_flash(torch, tfa, flash_report)

    log("phase 6: train at full width, bf16, attn_impl='flash'")
    flash_launches, train, (step, tparams, toks) = phase_train(torch, T, tfa)
    if "--profile" in sys.argv[1:]:
        log("profile: bf16 train steps under torch.profiler")
        _profile_window(torch, lambda: step(tparams, toks), 3,
                        "3 train steps")
    del step, tparams, toks

    log("phase 7: f32 train parity, flash kernels vs reference attention")
    parity = phase_train_parity(torch, T)

    log("phase 8: the paged kernel's dequant branch vs plain version")
    qerrs, qtiming = phase_kernels_quant(torch, tpa)

    params = T.init_params(
        cfg, torch.Generator(device="cuda").manual_seed(0), device="cuda")
    log("phase 9: quantized serving at full width, bf16")
    quant = phase_serve_quant(torch, T, tpa, ServingEngine, params, cfg)

    p32 = _tree_map(lambda t: t.float(), params)
    cfg32 = T.TransformerConfig(**FULL)
    log("phase 10: f32 quantized engines, kernel tokens vs gather tokens")
    phase_quant_identity(torch, T, ServingEngine, p32, cfg32)

    log("phase 11: spec decoding at full width, bf16 (plain decode first)")
    spec = phase_spec(torch, T, tpa, ServingEngine, params, cfg)

    log("phase 12: f32 spec tokens vs plain tokens")
    phase_spec_identity(torch, T, ServingEngine, p32, cfg32)
    if "--profile" in sys.argv[1:]:
        log("profile: bf16 serving_quant steps under torch.profiler")
        phase_profile_quant(torch, ServingEngine, params, cfg)
    del p32

    log("phase 13: decode windows and async dispatch at full width, bf16")
    windows = phase_windows(torch, T, tpa, ServingEngine, params, cfg)
    if "--profile" in sys.argv[1:]:
        log("profile: bf16 decode windows under torch.profiler")
        phase_profile_windows(torch, ServingEngine, params, cfg)

    log("phase 14: LoRA adapters at full width, bf16")
    adapters = phase_adapters(torch, T, tpa, ServingEngine, params, cfg)

    log("phase 15: KV fingerprints and the durable KV store, bf16")
    store = phase_integrity_store(torch, T, ServingEngine, params, cfg)
    del params

    from paddle_tpu_torch import fluid
    from paddle_tpu_torch.models import resnet
    torch.cuda.empty_cache()
    # every run of phases 16-36 is recorded; phase 37 verifies them
    recorder = _RunRecorder(fluid).__enter__()
    log("phase 16: Fluid ResNet-50 training, bf16 AMP, batch 128, 224x224")
    fluid_resnet = phase_fluid_resnet(torch, fluid, resnet,
                                      profile="--profile" in sys.argv[1:])

    log("phase 17: Fluid f32 parity, card vs CPU (resnet_cifar10 depth 8)")
    fluid_parity = phase_fluid_parity(torch, fluid, resnet)

    log("phase 18: the Fluid flash_attention op, one bf16 SGD step")
    fluid_flash = phase_fluid_flash(torch, fluid, tfa)

    from paddle_tpu_torch.models import ocr_crnn
    log("phase 20: the Fluid LSTM benchmark, bf16 AMP, batch 64 x 100 "
        "tokens, 2 x dynamic_lstm(512)")
    fluid_lstm = phase_fluid_lstm(torch, fluid,
                                  profile="--profile" in sys.argv[1:])
    log("phase 20 (sync check): the lstm kernel under "
        "torch.cuda.set_sync_debug_mode('error')")
    lstm_sync = phase_lstm_sync(torch)

    log("phase 21: ragged f32 parity, card vs CPU (book sentiment nets, "
        "CRNN)")
    ragged = phase_ragged_parity(torch, fluid, ocr_crnn)

    log("phase 22: the OCR CRNN at hidden 48, images [32, 1, 32, 128], f32")
    crnn = phase_crnn(torch, fluid, ocr_crnn)

    log("phase 23: control flow f32 parity, card vs CPU (NMT at test "
        "widths, a beam loop with the early exit, IfElse, Switch, "
        "StaticRNN, top_k ties)")
    control = phase_control_parity(torch, fluid)

    log("phase 24: the book's NMT at full width (dict 30000, width 512, "
        "beam 3), f32 Adagrad(1e-3), batch 64; beam decode")
    nmt = phase_nmt(torch, fluid, profile="--profile" in sys.argv[1:])

    from paddle_tpu_torch.models import ctr
    log("phase 25: bench.py's sparse-embedding benchmark (vocab 1,000,000 "
        "x 64, batch 4096 x 8 fields), SGD and Adam, sparse vs dense")
    sparse = phase_sparse_bench(torch, fluid,
                                profile="--profile" in sys.argv[1:])

    log("phase 26: sparse and sampled f32 parity, card vs CPU (the sparse "
        "embedding model x 4 optimizers, nce, hsigmoid, word2vec)")
    sparse_parity = phase_sparse_parity(torch, fluid)

    log("phase 27: Wide&Deep and DeepFM at full width (26 fields, "
        "1,040,000 ids, embeddings 10, deep 400-400-400), f32 Adam(1e-3), "
        "batch 2048")
    ctr_models = phase_ctr(torch, fluid, ctr,
                           profile="--profile" in sys.argv[1:])

    from paddle_tpu_torch.models import (alexnet, googlenet, lenet,
                                         mobilenet, ssd, vgg)
    log("phase 28: lrn, the CRF and detection ops, the learning-rate "
        "schedules and the evaluators, card vs CPU")
    new_ops = phase_new_op_parity(torch, fluid, card=card)

    log("phase 29: the book's MNIST LeNet (batch 64) and VGG-16-bn-drop "
        "CIFAR-10 (batch 128), f32 Adam(1e-3); card vs CPU")
    book_images = phase_book_images(torch, fluid, lenet, vgg, card=card)

    log("phase 30: bench.py's ImageNet zoo (AlexNet, GoogLeNet, VGG-16, "
        "MobileNet-v1) at [N, 3, 224, 224], bf16 AMP, Momentum(0.01, 0.9)")
    zoo = phase_image_zoo(torch, fluid, dict(
        alexnet=alexnet.alexnet, googlenet=googlenet.googlenet,
        vgg16=vgg.vgg16, mobilenet=mobilenet.mobilenet_v1),
        profile="--profile" in sys.argv[1:], card=card)

    log("phase 31: the book's SRL at its published widths (hidden 512, "
        "depth 8, conll05's dictionaries), batch 10 sentences")
    srl = phase_srl(torch, fluid, profile="--profile" in sys.argv[1:],
                    card=card)

    log("phase 32: SSD at VOC's shape ([32, 3, 300, 300], 21 classes, "
        "20,982 priors), f32 Adam(2e-3)")
    ssd_run = phase_ssd(torch, fluid, ssd,
                        profile="--profile" in sys.argv[1:], card=card)

    log("phase 33: the last 14 ops (3-D and transposed convolutions, "
        "pool3d, the _with_index pools, unpool, spp, norm, "
        "bilinear_tensor_product, modified_huber_loss, soft_relu, "
        "gaussian_random_noise, average_accumulates), card vs CPU")
    rest_ops = phase_rest_op_parity(torch, fluid, card=card)

    log("phase 34: ResNet-50 under memory_optimize (bench.py's "
        "resnet50_remat), bf16 AMP, batch 128")
    remat = phase_resnet_remat(torch, fluid, resnet, fluid_resnet,
                               card=card)

    log("phase 35: run_grad_accum: ResNet-50 f32 batch 128 in 4 "
        "micro-batches beside a plain step; LeNet vs its full-batch step")
    accum = phase_grad_accum(torch, fluid, resnet, lenet, card=card)

    log("phase 36: ModelAverage(0.15) and StaticPruning(0.5) on "
        "VGG-16-bn-drop CIFAR-10, batch 128, f32 Adam(1e-3)")
    ma_prune = phase_ma_prune(torch, fluid, vgg, card=card)
    recorder.__exit__()

    log("phase 37: the executor's surface: the verifier, the numerics "
        "guard, AsyncDeviceFeeder (ResNet-50 bf16 batch 128), profiler() "
        "and trace_profile (ResNet-50 bf16 batch 32)")
    surface = phase_executor_surface(torch, fluid, resnet, lenet,
                                     recorder, card=card)

    log("phase 38: the mesh executor on a world of one NCCL rank: "
        "ResNet-50 bf16 AMP batch 128 beside phase 16, the flash program")
    t0 = time.monotonic()
    mesh1 = phase_mesh_world1(torch, fluid, resnet, tfa, fluid_resnet,
                              card=card)
    log("phase 39: two ranks on the card (gloo): ResNet-50 f32, LeNet "
        "tensor-parallel and FSDP, row-split DeepFM, local SGD")
    mesh2 = phase_mesh_two_ranks(torch, fluid, resnet, lenet, ctr,
                                 card=card)
    log("  phases 38-39 took %.1f s" % (time.monotonic() - t0))
    from paddle_tpu_torch.parallel import DistributedContext
    DistributedContext.shutdown()

    log("phase 40: the legacy paddle train stack on benchmarks/paddle "
        "(ResNet-50, AlexNet, GoogLeNet, smallnet, VGG-19, the LSTM), f32")
    t0 = time.monotonic()
    legacy = phase_legacy(torch, fluid, resnet, card=card)
    log("  phase 40 took %.1f s" % (time.monotonic() - t0))

    log("phase 41: the elastic data plane: ResNet-50 b64 f32 from "
        "RecordShards, smallnet from record files, the supervised drill")
    t0 = time.monotonic()
    data_plane = phase_data_plane(
        torch, fluid, resnet, card=card,
        fluid16_ms=legacy["resnet_fluid_program"]["ms_per_step"])
    log("  phase 41 took %.1f s" % (time.monotonic() - t0))

    log("phase 42: the serving fleet at full width, 4 layers: failover, a "
        "tiered fleet with KV handoff, quantized pools, an f32 kill drill, a "
        "weight rollout with canaries, the front door, the batch lane")
    t0 = time.monotonic()
    torch.cuda.empty_cache()
    fleet = phase_fleet(torch, T, tpa, card=card, full=HALF_DEPTH)
    log("  phase 42 took %.1f s" % (time.monotonic() - t0))

    log("phase 43: the LM's remaining paths at full width: ring, zigzag "
        "and Ulysses + flash over {seq: 2}, the Switch LM over {expert: "
        "2}, {model: 2} parameters, the GPipe pipeline, and on one rank "
        "the Switch LM's training, decoding, paged, beam and chunked "
        "prefill paths")
    t0 = time.monotonic()
    lm_paths = phase_lm_paths(torch, T, tfa, tpa, card=card)
    log("  phase 43 took %.1f s" % (time.monotonic() - t0))

    log("phase 44: the v2 book and the deploy path: recognize_digits "
        "(LeNet) through the v2 API from paddle.dataset.mnist, "
        "understand_sentiment (stacked_lstm_net, emb 128, hid 512) through "
        "Fluid from imdb, fit_a_line from uci_housing, mnist.convert; the "
        "native runner and merge_v2_model on the host")
    v2_book = phase_v2_book(torch, card=card)

    log("phase 45: the utils/ tools and the analyzers: images to batches, "
        "a spawn decode pool, predefined_net.small_vgg trained through "
        "the legacy trainer, dump_config, make_model_diagram, "
        "dump_v2_config and show_pb, torch2paddle, plotcurve, the lint "
        "gate")
    tools = phase_tools(torch, card=card)

    log("phase 19: the bf16 paged calls' two kernels under torch.profiler")
    phase_split_times(torch, list(timing.values()) + list(qtiming.values()))

    kernels = []
    paged_note = "no single PyTorch call computes paged attention"

    def paged_fields(which, pool, tm):
        """The two CUDA kernels a bf16 call of this wrapper launches (Dh
        64), their resources and device times, and the partitions."""
        split = "paged_split_kernel<%s, %d, 2>" % (
            pool, {"decode": 1, "verify": 4, "prefill": 16}[which])
        return {
            "cuda_kernels": [split, "paged_merge_kernel"],
            "partitions": tm["partitions"],
            "split_kernel_ms": tm["split_kernel_ms"],
            "merge_kernel_ms": tm["merge_kernel_ms"],
            "split_plain_ms": tm["split_plain_ms"],
            "design": "split context over %d partitions, CUDA cores, f32 "
                      "math, cp.async ring per warp" % tm["partitions"],
            "resources": dict(
                {k: paged_report.get(k) for k in
                 (split, "paged_merge_kernel")},
                split_shared_bytes=tm["shared_bytes"]),
        }

    def window_launches(kvq=None):
        """The decode window phase's launches of one wrapper, by run."""
        pre = "" if kvq is None else kvq + " "
        return {label[len(pre):]: r["launches"]
                for label, r in windows.items()
                if label.startswith(pre) and (kvq is not None or
                                              label.startswith("K="))}

    for which in ("decode", "prefill", "verify"):
        tm = timing[which]
        kernels.append(dict({
            "name": "paged_attention (%s, paged_%s_attention)"
                    % (which, which),
            "route": "cuda", "source": SOURCE, "replaces": TPU_KERNEL,
            "launches": (spec["none"]["launches"]["verify"]
                         if which == "verify" else launches[which]),
            "window_launches": {k: v[which] for k, v in
                                window_launches().items()},
            "adapter_launches": adapters["launches"][which],
            "fleet_launches": {k: fleet["launches"][k][which] for k in
                               ("n1", "n3", "n3_kill", "tiered")},
            "lm_paths_launches": lm_paths["paged_launches"][which],
            "max_abs_err": errs[(which, "bfloat16")],
            "max_abs_err_f32": errs[(which, "float32")],
            "ms": tm["ms"], "plain_ms": tm["plain_ms"],
            "bound_ms": tm["bound_ms"], "bound_by": tm["bound_by"],
            "library_ms": None, "library_note": paged_note, "card": card,
        }, **paged_fields(which, "bf16", tm)))
    for kvq in ("int8", "fp8"):
        for which in ("decode", "prefill", "verify"):
            # each entry's numbers come from the shape its launches ran
            # at: decode and prefill from phase 9 (Bt 32), verify from
            # phase 11 (Bt 16)
            if which == "verify":
                key, n = ("verify_spec", kvq), spec[kvq]["launches"]["verify"]
                unq = timing["verify"]["ms"]
            else:
                key, n = (which, kvq), quant[kvq]["launches"][which]
                unq = qtiming[(which, "none")]["ms"]
            tm = qtiming[key]
            kernels.append(dict({
                "name": "paged_attention dequant (%s, %s pool, "
                        "paged_%s_attention)" % (which, kvq, which),
                "route": "cuda", "source": SOURCE,
                "replaces": TPU_KERNEL + " (quant=True branch)",
                "launches": n,
                "window_launches": {k: v[which] for k, v in
                                    window_launches(kvq).items()},
                "fleet_launches": fleet["launches"]["n3_" + kvq][which],
                "lm_paths_launches":
                    lm_paths["paged_quant_launches"][kvq][which],
                "max_abs_err": qerrs[key + ("bfloat16",)],
                "max_abs_err_f32": qerrs[key + ("float32",)],
                "ms": tm["ms"], "plain_ms": tm["plain_ms"],
                "bound_ms": tm["bound_ms"], "bound_by": tm["bound_by"],
                "unquantized_ms_same_shape": unq,
                "library_ms": None, "library_note": paged_note,
                "card": card,
            }, **paged_fields(which, "int8" if kvq == "int8" else "e4m3",
                              tm)))
    for which in ("forward", "backward_kv", "backward_q"):
        tm = flash_timing[which]
        kernels.append({
            "name": "flash_attention (%s, flash_%s)" % (which, which),
            "route": "cuda", "source": FLASH_SOURCE,
            "replaces": FLASH_REPLACES[which],
            "launches": flash_launches[which],
            "fluid_launches": fluid_flash["launches"][which],
            "mesh_launches": mesh1["flash_launches"][which],
            "fleet_launches": fleet["flash_launches"][which],
            "lm_paths_launches": {
                "ulysses_per_rank": lm_paths["flash_launches"][which],
                "switch_lm": lm_paths["switch_flash_launches"][which]},
            "max_abs_err": flash_errs["bfloat16"][which],
            "max_abs_err_f32": flash_errs["float32"][which],
            "ms": tm["ms"], "plain_ms": tm["plain_ms"],
            "bound_ms": tm["bound_ms"], "bound_by": tm["bound_by"],
            "library_ms": tm["library_ms"],
            "library_note": "scaled_dot_product_attention, is_causal=True"
                            + (" (forward)" if which == "forward" else
                               " (backward: dq, dk, dv together)"),
            "design": ("tensor cores, mma.sync m16n8k16 bf16"
                       if "_mma_" in tm["kernel"] else "CUDA cores, f32 FMA"),
            "kernel": tm["kernel"], "resources": tm["resources"],
            "card": card,
        })
    log("kernels: " + ", ".join("%s launches=%d" % (k["name"], k["launches"])
                                for k in kernels))
    idle = [k["name"] for k in kernels if not k["launches"]]
    check(not idle, "kernels never launched on a main path: %s" % idle)
    log("serving: %s" % json.dumps(serve))
    log("quantized serving: %s" % json.dumps(quant))
    log("spec decoding: %s" % json.dumps(spec))
    log("decode windows: %s" % json.dumps(windows))
    log("adapters: %s" % json.dumps(adapters))
    log("fingerprints and store: %s" % json.dumps(store))
    log("training: %s" % json.dumps(dict(train, **parity)))
    log("fluid: %s" % json.dumps(dict(resnet50=fluid_resnet,
                                      f32_parity=fluid_parity,
                                      flash_op=fluid_flash,
                                      lstm=fluid_lstm, lstm_sync=lstm_sync,
                                      ragged_f32_parity=ragged,
                                      crnn=crnn, control_f32_parity=control,
                                      nmt=nmt, sparse_bench=sparse,
                                      sparse_f32_parity=sparse_parity,
                                      ctr=ctr_models, new_ops=new_ops,
                                      book_images=book_images,
                                      image_zoo=zoo, srl=srl,
                                      ssd=ssd_run, rest_ops=rest_ops,
                                      resnet50_remat=remat,
                                      grad_accum=accum,
                                      model_average_pruning=ma_prune,
                                      executor_surface=surface,
                                      mesh_world1=mesh1,
                                      mesh_two_ranks=mesh2,
                                      legacy_trainer=legacy,
                                      data_plane=data_plane)))
    log("fleet: %s" % json.dumps(fleet))
    log("lm paths: %s" % json.dumps(lm_paths))
    log("v2 book: %s" % json.dumps(v2_book))
    log("tools: %s" % json.dumps(tools))
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
