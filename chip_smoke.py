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
 then print the kernels' JSON line (every kernel must have launched on
 a main path; the paged entries also carry their launches in phases 13
 and 14, the flash entries their Fluid launches in phase 18; no Hopper
 kernel lies on the path of phases 20-24, whose recurrences, segment
 ops, CTC, loops and beam search are plain torch ops), then the device
 line last.

No request count of phases 9, 11 and 13 is cut; phases 10 and 12 run the
trace's first 8 requests.

With --profile, torch.profiler also reads the device-busy share and the
top kernels over the bf16 trace's first steps and steady decode steps,
over 3 train steps, over 24 steps of the serving_quant configuration
with kv_quant none and int8, and over 12 steps of 16 megabatch requests
at K=1 sync and K=8 async, and over 3 Fluid ResNet-50 steps, 3 Fluid
LSTM steps, 3 Fluid NMT training steps and one NMT beam decode (device
time by class and by region: forward, backward, optimizer).

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
# matrix products each flash kernel does per attended (q, k) pair
FLASH_PRODUCTS = {"forward": 2, "backward_kv": 4, "backward_q": 3}

FULL = dict(vocab=32000, dim=512, heads=8, layers=8, max_len=1024)
ENGINE = dict(max_slots=16, kv_block_tokens=16, prefill_chunk_tokens=128,
              prefix_cache_tokens=8192)
# the repo's training configuration (bench.py:913-931): tokens [8, 1025]
TRAIN = dict(batch=8, seq=1024, lr=1e-3)


def log(*a):
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
    tpa.paged_decode_attention.launches = 0
    tpa.paged_prefill_attention.launches = 0
    tpa.paged_verify_attention.launches = 0
    t0 = time.monotonic()
    hs = [eng.submit(**r) for r in reqs[:-1]]
    eng.run()
    hs.append(eng.submit(**reqs[-1]))  # after the first copy published
    eng.run()
    _sync(torch, dev)
    wall = time.monotonic() - t0
    launches = {"decode": tpa.paged_decode_attention.launches,
                "prefill": tpa.paged_prefill_attention.launches,
                "verify": tpa.paged_verify_attention.launches}
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
    for w in (tpa.paged_decode_attention, tpa.paged_prefill_attention,
              tpa.paged_verify_attention):
        w.launches = 0


def read_launches(tpa):
    return {"decode": tpa.paged_decode_attention.launches,
            "prefill": tpa.paged_prefill_attention.launches,
            "verify": tpa.paged_verify_attention.launches}


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


def profile_fluid(torch, run, n, label):
    """torch.profiler over `run()` n times: wall, device-busy share and
    device ops per step; device ms per step by kernel class; and the
    forward and optimizer regions (the lowering's record_function ranges)
    as the sum of their kernels' device time; autograd's engine thread
    launches the backward's kernels, so the backward is the rest of the
    busy time. The optimizer's
    kernels are elementwise: the elementwise class includes them."""
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
               and _device_us(e) > 0 and e.key not in FLUID_REGIONS]
    busy = sum(_device_us(e) for e in kernels) / 1e6
    classes = {}
    for e in kernels:
        c = _fluid_class(e.key)
        classes[c] = classes.get(c, 0.0) + _device_us(e) / 1e3 / n
    regions = {}
    for e in avgs:
        if e.key in FLUID_REGIONS and getattr(
                e, "device_type", None) == DeviceType.CPU:
            total = getattr(e, "device_time_total",
                            getattr(e, "cuda_time_total", 0.0))
            regions[e.key] = total / 1e3 / n
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
    for e in sorted(kernels, key=_device_us, reverse=True)[:8]:
        log("    %-60s %6d calls %9.3f ms device"
            % (e.key[:60], e.count, _device_us(e) / 1e3))
    return dict(wall_ms=wall / n * 1e3, busy_ms=busy / n * 1e3,
                busy_share=busy / wall, ops_per_step=ops, classes=classes,
                regions=regions)


def phase_fluid_resnet(torch, fluid, resnet, profile=False, warm=2,
                       steps=10, place=None, cfg=FLUID_RESNET):
    """Phase 16: the headline ResNet-50 configuration trained through the
    port's Fluid Executor on the card (`place` and `cfg` shrink it for a
    rehearsal on the CPU)."""
    main, startup, avg = fluid_image_program(
        fluid, lambda x, c: resnet.resnet_imagenet(x, c, depth=cfg["depth"]),
        cfg["shape"], cfg["classes"], amp=True)
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
            share = ips * 3 * RESNET50_FWD_FLOPS / PEAK_FLOPS["bfloat16"]
            log("  %d parameters; startup %.1f s, %d warm-up steps %.1f s "
                "(cudnn.benchmark on)" % (n_params, startup_s, warm, warm_s))
            log("  losses %s" % ", ".join("%.4f" % x for x in losses))
            log("  %d steps of batch %d: %.3f ms/step, %.1f img/s, peak "
                "device memory %.2f GiB, FLOP share %.4f of 989 TFLOP/s "
                "(bench.py's count)" % (steps, cfg["batch"], wall / steps
                                        * 1e3, ips, peak / 2 ** 30, share))
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


def phase_fluid_flash(torch, fluid, tfa, place=None, cfg=FLUID_FLASH):
    """Phase 18: a Fluid program whose flash_attention op reaches the
    Hopper kernels, forward and backward, through one bf16 SGD step of
    the Executor (on the CPU, a rehearsal: the plain versions run and no
    kernel launches)."""
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
        exe = fluid.Executor(place or fluid.CUDAPlace(0))
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


def _tree_map(fn, x):
    if isinstance(x, dict):
        return {k: _tree_map(fn, v) for k, v in x.items()}
    if isinstance(x, list):
        return [_tree_map(fn, v) for v in x]
    return fn(x)


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
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
                                      nmt=nmt)))
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
