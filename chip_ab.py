#!/usr/bin/env python3
"""Compare two checkouts of the repository on one CUDA card.

    python3 chip_ab.py PARENT_DIR [CHANGE_DIR]

Runs chip_smoke.py's kernel timings (phase 2's paged shapes and phase
5's flash kernels at the training shape, q in bf16 and in f32, and the
paged wrappers with q in f32 over int8 and e4m3 pools at phase 8's
shapes), its serving phases (3, 9 and 11), its training step (phase
6) and the same step in f32 (from the port's public API, so that any
checkout runs it) from each checkout, each run in a
process of its own started in that checkout, in the order parent,
change, change, parent: both sides see the same card and the same
host. Each run's output is passed through and ends with one line
`AB <side> <json>`; the exit code is non-zero if any run failed.
CHANGE_DIR defaults to the checkout that holds this script. Needs what
chip_smoke.py needs: one CUDA card and nvcc; each checkout builds its
own kernels.
"""

import os
import subprocess
import sys

RUN = r'''
import importlib, json, sys, time
import numpy as np
import torch
import chip_smoke as cs
from paddle_tpu_torch import _build
from paddle_tpu_torch.models import transformer as T
from paddle_tpu_torch.parallel import paged_attention as tpa
from paddle_tpu_torch.serving import ServingEngine

tfa = importlib.import_module("paddle_tpu_torch.parallel.flash_attention")
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
_build.build(["paged_attention", "flash_attention"])
report = {}
for name, use in cs.ptxas_usage(
        _build.compiler_output("flash_attention")).items():
    if cs._kernel_label(name):
        report[cs._kernel_label(name)] = dict(use, tensor_core_ops=None)
_, paged, paged32 = cs.phase_kernels(torch, tpa)
_, flash, flash32 = cs.phase_flash(torch, tfa, report)
# q in f32 over int8 and e4m3 pools: decode and prefill at phase 8's
# serving_quant shape, verify at the spec engine's
rng = np.random.RandomState(3)
qshapes = dict(H=8, Dh=64, Bt=32, MAXB=32, NB=1024)
quant32 = {}
for kvq in ("int8", "fp8"):
    for which, R, S, base, shapes in (
            ("decode", 1, 32, None, qshapes),
            ("prefill", 128, 1, [256], qshapes),
            ("verify", 4, 32, None, cs.SPEC_SHAPES)):
        c = cs.make_case(rng, torch, torch.float32, S=S, R=R, base=base,
                         parked=which != "prefill", kvq=kvq, **shapes)
        quant32["%s %s" % (which, kvq)] = cs.time_case(
            torch, tpa, which, c, "%s f32 q" % kvq)["ms"]
cfg = T.TransformerConfig(dtype=torch.bfloat16, **cs.FULL)
params = T.init_params(
    cfg, torch.Generator(device="cuda").manual_seed(0), device="cuda")
_, serve = cs.phase_serve(torch, T, tpa, ServingEngine, params, cfg)
quant = cs.phase_serve_quant(torch, T, tpa, ServingEngine, params, cfg)
spec = cs.phase_spec(torch, T, tpa, ServingEngine, params, cfg)
del params
_, train, _ = cs.phase_train(torch, T, tfa)
# the f32 training step: 2 warm-up steps, then 5 timed ones
cfg32 = T.TransformerConfig(dtype=torch.float32, **cs.FULL)
p32 = T.init_params(
    cfg32, torch.Generator(device="cuda").manual_seed(1), device="cuda")
toks = torch.from_numpy(cs.train_tokens(cfg32.vocab)).to("cuda")
step = T.make_train_step(cfg32, lr=cs.TRAIN["lr"], attn_impl="flash")
for _ in range(2):
    step(p32, toks)
torch.cuda.synchronize()
t0 = time.monotonic()
for _ in range(5):
    step(p32, toks)
torch.cuda.synchronize()
train32_ms = (time.monotonic() - t0) / 5 * 1e3
del p32, step
print("AB %s %s" % (sys.argv[1], json.dumps(dict(
    card=cs.gpu_line(),
    paged_ms={k: v["ms"] for k, v in paged.items()},
    paged_f32_ms={k: v["ms"] for k, v in paged32.items()},
    paged_f32_q_quant_pool_ms=quant32,
    flash_ms={k: v["ms"] for k, v in flash.items()},
    flash_f32_ms={k: v["ms"] for k, v in flash32.items()},
    sdpa_f32_ms={k: flash32[k]["library_ms"] for k in ("forward",
                                                        "backward_kv")},
    flash_f32_kernels={k: [v["kernel"], v["resources"]]
                       for k, v in flash32.items()},
    serve_tokens_per_s=serve["tokens_per_s"],
    quant_tokens_per_s={k: v["tokens_per_s"] for k, v in quant.items()},
    spec_tokens_per_s={k: v["tokens_per_s"] for k, v in spec.items()},
    train_ms_per_step=train["ms_per_step"],
    train_tokens_per_s=train["tokens_per_s"],
    train_f32_ms_per_step=train32_ms))), flush=True)
'''


def main(argv):
    if len(argv) not in (2, 3):
        print(__doc__, file=sys.stderr)
        return 2
    parent = os.path.abspath(argv[1])
    change = os.path.abspath(argv[2] if len(argv) == 3 else
                             os.path.dirname(os.path.abspath(__file__)))
    failed = 0
    for side, tree in (("parent", parent), ("change", change),
                       ("change", change), ("parent", parent)):
        res = subprocess.run([sys.executable, "-c", RUN, side], cwd=tree,
                             capture_output=True, text=True, check=False)
        print(res.stdout, end="", flush=True)
        if res.returncode:
            failed += 1
            print("%s run in %s failed (exit %d):\n%s"
                  % (side, tree, res.returncode, res.stderr[-4000:]),
                  file=sys.stderr, flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
