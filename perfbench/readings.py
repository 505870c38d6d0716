"""Readings of the numbers a cell compares, without its measured
window: the program's over many seeds, the control's (the reference in
the next lower precision, put in the program's place) and a planted
fault's. The limits in perfbench/workloads/<cell>.json are set from
these. One JSON line a seed:

    python3 perfbench/readings.py --workload gpt2m.train --seeds 1,2,3 \
        [--mode control] [--fault half_batch] [--seconds 0]

`--mode bf16` (resnet50.train) puts the reference computed as a bf16
AMP step in the program's place: a witness of what bf16 rounding alone
reads, beside the program's readings.

`--seconds` runs the cell's window first (serving cells judge what the
window served)."""

import argparse
import gc
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None):
    os.environ["USE_FLAX"] = "0"
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    import torch

    from perfbench.lib import harness

    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--mode", default="program",
                   choices=("program", "control", "bf16"))
    p.add_argument("--fault", default=None)
    p.add_argument("--seconds", type=float, default=0.0)
    args = p.parse_args(argv)
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.monotonic()
        cell = harness.Cell(args.workload, seed=seed, mode=args.mode,
                            fault=args.fault)
        run = harness.driver(cell).setup(cell)
        run.sync()
        t1 = time.monotonic()
        if args.seconds > 0:
            run.window(args.seconds)
        run.release()
        t2 = time.monotonic()
        readings = run.check()
        t3 = time.monotonic()
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "mode": args.mode, "fault": args.fault,
                          "readings": readings, "setup_s": t1 - t0,
                          "check_s": t3 - t2,
                          "worst": getattr(run, "detail", None)}),
              flush=True)
        del run
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
